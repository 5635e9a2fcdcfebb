"""The port's tuning table held against the JAX package's on the CPU: the
same ``record``/``consult`` sequence on a plane of each package gives the
same outcome ladder (``disabled``, ``absent``, ``mismatch``, ``stale``,
``invalid``, ``loaded``) and writes the same entries, timestamps aside;
each package reads the other's table file; a wrong schema version refuses
a table wholesale; the honesty gate refuses numbers that were never
measured; the device kind is the device's, not the process's; and
``GET /tunez`` serves the port's snapshot (schema-checked, ``?space=``,
500 on a malformed one, also while draining).
"""

import json
import time
import urllib.request

import pytest
import torch

from synapseml_tpu.telemetry import tunetable as JT
from synapseml_tpu_torch.telemetry import tunetable as TT
from synapseml_tpu_torch.telemetry.artifact import SchemaError, read_json
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

PACKAGES = [("jax", JT), ("port", TT)]


def _ladder(mod, directory):
    """One scripted record/consult sequence → (the outcomes, the plane)."""
    off = mod.TunePlane(directory=None, kind="cpu")
    plane = mod.TunePlane(directory=directory, kind="cpu")
    outcomes = []

    def consult(p, *a, **k):
        won = p.consult("site", *a, **k)
        outcomes.append((p.snapshot()["consults"][-1]["outcome"], won))
    consult(off, "sp", "g=1")
    consult(plane, "never_tuned", "g=1")
    plane.record("sp", "g=1", {"tile": 8}, measured_ms=1.5, trials=3)
    plane.record("sp", "g=2", {"tile": 16}, measured_ms=0.5, trials=2)
    consult(plane, "sp", "g=3")
    consult(plane, "sp", "g=1", validate=lambda w: w["tile"] > 8)
    consult(plane, "sp", "g=1", validate=lambda w: 1 / 0)
    consult(plane, "sp", "g=1")
    consult(plane, "sp", "g=2", validate=lambda w: w["tile"] == 16)
    aged = mod.TunePlane(directory=directory, kind="cpu", max_age_s=1e-9)
    time.sleep(0.01)
    consult(aged, "sp", "g=1")
    other = mod.TunePlane(directory=directory, kind="some_other_card")
    consult(other, "sp", "g=1")
    return outcomes, plane


def test_outcome_ladder_equals_reference(tmp_path):
    (j, jp), (t, tp) = [_ladder(mod, str(tmp_path / name))
                        for name, mod in PACKAGES]
    assert t == j
    assert [o for o, _ in t] == ["disabled", "absent", "mismatch",
                                 "invalid", "invalid", "loaded", "loaded",
                                 "stale", "mismatch"]
    assert {o for o, _ in t} == set(TT.CONSULT_OUTCOMES)
    assert TT.CONSULT_OUTCOMES == JT.CONSULT_OUTCOMES
    assert TT.ENTRY_KEYS == JT.ENTRY_KEYS
    assert TT.TUNE_TABLE_ENV == JT.TUNE_TABLE_ENV == "SMLTPU_TUNE_TABLE_DIR"


def _entries(path):
    obj = json.load(open(path, encoding="utf-8"))
    return [{k: v for k, v in e.items() if k != "measured_unix"}
            for e in obj["entries"]], obj["schema_version"]


def test_both_write_the_same_entries(tmp_path):
    written = []
    for name, mod in PACKAGES:
        _ladder(mod, str(tmp_path / name))
        written.append(_entries(TT.table_path(str(tmp_path / name))))
    assert written[0] == written[1]
    assert written[1][0][0]["device_kind"] == "cpu"


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_table(tmp_path, writer, reader):
    mods = dict(PACKAGES)
    w = mods[writer].TunePlane(directory=str(tmp_path), kind="cpu")
    w.record("shared_space", "features=28", {"fpb": 14, "tile": 512},
             measured_ms=0.25, trials=3)
    r = mods[reader].TunePlane(directory=str(tmp_path), kind="cpu")
    assert r.consult("site", "shared_space", "features=28") == {
        "fpb": 14, "tile": 512}
    mods[reader].check_tunez(r.snapshot())


@pytest.mark.parametrize("name,mod", PACKAGES)
def test_wrong_schema_version_refuses_the_table_wholesale(tmp_path, name,
                                                          mod):
    with open(TT.table_path(str(tmp_path)), "w", encoding="utf-8") as f:
        json.dump({"schema_version": TT.TUNE_TABLE_SCHEMA_VERSION + 1,
                   "written_unix": 0.0,
                   "entries": [{"space": "sp", "device_kind": "cpu",
                                "geometry": "g", "winner": {"x": 1},
                                "measured_ms": 1.0, "trials": 1,
                                "measured_unix": time.time(),
                                "source": "autotune"}]}, f)
    p = mod.TunePlane(directory=str(tmp_path), kind="cpu")
    assert p.consult("s", "sp", "g") is None
    snap = p.snapshot()
    assert snap["load_error"] is not None and snap["entries"] == []
    assert snap["consults"][-1]["outcome"] == "mismatch"


@pytest.mark.parametrize("bad", [
    dict(measured_ms=0.0), dict(measured_ms=-1.0),
    dict(measured_ms=float("nan")), dict(measured_ms=float("inf")),
    dict(trials=0), dict(winner={})])
def test_honesty_gate_refuses_like_reference(tmp_path, bad):
    kw = dict(winner={"x": 1}, measured_ms=1.0, trials=1)
    kw.update(bad)
    for name, mod in PACKAGES:
        p = mod.TunePlane(directory=str(tmp_path / name), kind="cpu")
        with pytest.raises(ValueError):
            p.record("sp", "g", kw["winner"], measured_ms=kw["measured_ms"],
                     trials=kw["trials"])
    with pytest.raises(ValueError, match="no table directory"):
        TT.TunePlane(directory=None).record("sp", "g", {"x": 1}, 1.0, 1)


def test_geometry_key_and_table_path_equal_reference(tmp_path):
    dims = dict(max_len=256, kv_heads=4, d_head=64, span=1)
    assert TT.geometry_key(**dims) == JT.geometry_key(**dims)
    assert TT.table_path(str(tmp_path)) == JT.table_path(str(tmp_path))


def test_device_kind_is_the_devices():
    assert TT.device_kind("cpu") == "cpu"
    assert TT.device_kind(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        assert TT.device_kind() == "cpu"
    p = TT.TunePlane(directory=None)
    assert p.kind_of("cpu") == "cpu"
    assert TT.TunePlane(directory=None, kind="pinned").kind_of("cpu") == \
        "pinned"


def test_a_cpu_consult_never_loads_another_devices_winner(tmp_path):
    card = TT.TunePlane(directory=str(tmp_path),
                        kind="nvidia_h100_80gb_hbm3")
    card.record("sp", "g", {"variant": "single"}, 0.01, 3)
    p = TT.TunePlane(directory=str(tmp_path))
    assert p.consult("s", "sp", "g", device="cpu") is None
    assert p.snapshot()["consults"][-1]["outcome"] == "mismatch"
    entry = p.record("sp", "g", {"variant": "split"}, 1.0, 3, device="cpu")
    assert entry["device_kind"] == "cpu"
    assert p.consult("s", "sp", "g", device="cpu") == {"variant": "split"}
    kinds = {e["device_kind"]: e["matches_device"]
             for e in p.snapshot()["entries"]}
    assert kinds == {"cpu": p.kind == "cpu",
                     "nvidia_h100_80gb_hbm3":
                         p.kind == "nvidia_h100_80gb_hbm3"}


def test_get_tuneplane_follows_env_unless_pinned(monkeypatch, tmp_path):
    prev = TT.set_tuneplane(None)
    try:
        monkeypatch.delenv(TT.TUNE_TABLE_ENV, raising=False)
        assert TT.get_tuneplane().directory is None
        monkeypatch.setenv(TT.TUNE_TABLE_ENV, str(tmp_path))
        assert TT.get_tuneplane().directory == str(tmp_path)
        pinned = TT.TunePlane(directory=None)
        TT.set_tuneplane(pinned)
        assert TT.get_tuneplane() is pinned
    finally:
        TT.set_tuneplane(prev)


def test_reload_reads_another_writers_entries(tmp_path):
    reader = TT.TunePlane(directory=str(tmp_path), kind="cpu")
    assert reader.consult("s", "sp", "g") is None
    TT.TunePlane(directory=str(tmp_path), kind="cpu").record(
        "sp", "g", {"x": 2}, 1.0, 1)
    assert reader.consult("s", "sp", "g") is None      # the loaded view
    reader.reload()
    assert reader.consult("s", "sp", "g") == {"x": 2}
    read_json(TT.table_path(str(tmp_path)), schema=TT.check_tune_table)


@pytest.mark.parametrize("bad", [
    [], {"schema_version": 1},
    {"schema_version": 1, "directory": None, "device_kind": "cpu",
     "max_age_s": 1.0, "load_error": None, "entries": [],
     "consults": [{"site": "s", "space": "sp", "geometry": "g",
                   "outcome": "guessed", "unix": 0.0}]}])
def test_check_tunez_refuses_like_reference(bad):
    for mod in (JT, TT):
        with pytest.raises(ValueError):
            mod.check_tunez(bad)


# -- GET /tunez ---------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def served_plane(tmp_path):
    from synapseml_tpu_torch.serving.server import ServingServer
    plane = TT.TunePlane(directory=str(tmp_path), kind="cpu")
    plane.record("space_a", "g=1", {"x": 1}, 1.0, 1)
    plane.record("space_b", "g=1", {"y": 2}, 2.0, 2)
    plane.consult("site_a", "space_a", "g=1")
    plane.consult("site_b", "space_b", "g=9")
    prev = TT.set_tuneplane(plane)
    srv = ServingServer()
    try:
        yield plane, srv
    finally:
        srv.close()
        TT.set_tuneplane(prev)


def test_tunez_serves_the_checked_snapshot(served_plane):
    plane, srv = served_plane
    status, body = _get(srv.url_for("/tunez"))
    assert status == 200
    snap = json.loads(body)
    TT.check_tunez(snap)
    JT.check_tunez(snap)
    assert [c["outcome"] for c in snap["consults"]] == ["loaded",
                                                        "mismatch"]
    status, body = _get(srv.url_for("/tunez?space=space_b"))
    snap = json.loads(body)
    assert {e["space"] for e in snap["entries"]} == {"space_b"}
    assert [c["site"] for c in snap["consults"]] == ["site_b"]


def test_tunez_answers_500_for_a_malformed_snapshot(served_plane,
                                                    monkeypatch):
    plane, srv = served_plane
    good = plane.snapshot
    monkeypatch.setattr(plane, "snapshot",
                        lambda: {**good(), "entries": "not a list"})
    status, body = _get(srv.url_for("/tunez"))
    assert status == 500 and b"failed validation" in body


def test_tunez_is_served_while_draining(served_plane):
    plane, srv = served_plane
    srv.health.begin_drain()
    assert _get(srv.url_for("/tunez"))[0] == 200


def test_tunez_without_a_table_is_disabled_and_valid():
    from synapseml_tpu_torch.serving.server import ServingServer
    prev = TT.set_tuneplane(TT.TunePlane(directory=None))
    srv = ServingServer()
    try:
        status, body = _get(srv.url_for("/tunez"))
        snap = json.loads(body)
        assert status == 200 and snap["directory"] is None
        TT.check_tunez(snap)
    finally:
        srv.close()
        TT.set_tuneplane(prev)


def test_schema_error_is_a_value_error():
    assert issubclass(SchemaError, ValueError)
