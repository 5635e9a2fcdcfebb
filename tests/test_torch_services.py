"""The port's service stages against the JAX package's, on the CPU.

Each test builds the same stage in both packages over the same
``Dataset`` contents (numpy, from a seed), runs both against one
recording mock server (``torch_service_mocks``) and asserts that

- the recorded requests are equal: method, path, query, body bytes and
  headers other than ``User-Agent``;
- the output and ``errors`` columns are equal (binary outputs byte for
  byte);

and then checks what the JAX package's own test of that stage checks, on
the port's output.  Every retry policy here has zero delay, so no test
sleeps out a backoff; no test leaves 127.0.0.1.
"""

import types

import numpy as np
import pytest

import synapseml_tpu as jx
import synapseml_tpu.services as jx_services
import synapseml_tpu_torch as pt
import synapseml_tpu_torch.services as pt_services
from synapseml_tpu.core.pipeline import _STAGE_REGISTRY as JX_REGISTRY
from synapseml_tpu.resilience import drop_breaker as jx_drop_breaker
from synapseml_tpu_torch.core.pipeline import load_stage as pt_load_stage
from synapseml_tpu_torch.resilience import drop_breaker as pt_drop_breaker
from torch_service_mocks import MockServices, canonical, same_value

PACKAGES = {
    "jax": types.SimpleNamespace(Dataset=jx.Dataset, svc=jx_services,
                                 RetryPolicy=jx.RetryPolicy),
    "torch": types.SimpleNamespace(Dataset=pt.Dataset, svc=pt_services,
                                   RetryPolicy=pt.RetryPolicy),
}


@pytest.fixture(scope="module")
def mock():
    m = MockServices(embed_dim=16, seed=0)
    yield m
    m.close()


def obj_col(values) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    col[:] = list(values)
    return col


def run_both(mock, build, cols=("output", "errors"), concurrent=False,
             verb="transform"):
    """``build(pkg, url) -> (stage, ds)`` in each package; run the stage
    against ``mock``; assert equal requests and equal ``cols``.  Returns
    the port's result."""
    outs, reqs = {}, {}
    for name, pkg in PACKAGES.items():
        mock.take()
        stage, ds = build(pkg, mock.url)
        outs[name] = getattr(stage, verb)(ds)
        reqs[name] = mock.take()
    if concurrent:
        reqs = {k: canonical(v) for k, v in reqs.items()}
    assert reqs["jax"] == reqs["torch"]
    if verb == "transform":
        for c in cols:
            a, b = list(outs["jax"][c]), list(outs["torch"][c])
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                assert same_value(x, y), (c, i, x, y)
    return outs["torch"], reqs["torch"]


# -- the JAX package's tests/test_services.py, each against the port -------

class TestVision:
    def test_analyze_image_url_column(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"img": np.array(["http://a/1.jpg",
                                               "http://a/2.jpg"])})
            stage = pkg.svc.AnalyzeImage(url=url + "/vision/analyze",
                                         visualFeatures=["Categories",
                                                         "Tags"])
            stage.set_col("imageUrl", "img")
            return stage, ds
        out, reqs = run_both(mock, build)
        assert out["output"][0]["url"] == "http://a/1.jpg"
        assert out["output"][0]["features"] == "Categories,Tags"
        assert len(reqs) == 2

    def test_analyze_image_bytes(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"img": obj_col([b"\x89PNGfake"])})
            stage = pkg.svc.AnalyzeImage(url=url + "/vision/analyze")
            stage.set_col("imageBytes", "img")
            return stage, ds
        out, reqs = run_both(mock, build)
        assert out["output"][0]["nbytes"] == 8
        assert reqs[0]["body"] == b"\x89PNGfake"

    def test_describe_parses_description(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"img": np.array(["http://a/1.jpg"])})
            stage = pkg.svc.DescribeImage(url=url + "/vision/describe")
            stage.set_col("imageUrl", "img")
            return stage, ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["captions"][0]["text"] == "a mock caption"

    def test_thumbnails_binary_output(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"img": np.array(["http://a/1.jpg"])})
            stage = pkg.svc.GenerateThumbnails(url=url + "/vision/thumb",
                                               width=48, height=48)
            stage.set_col("imageUrl", "img")
            return stage, ds
        out, _ = run_both(mock, build)
        assert out["output"][0] == b"THUMB48"


class TestFace:
    def test_detect(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"img": np.array(["http://a/f.jpg"])})
            stage = pkg.svc.DetectFace(url=url + "/face/detect",
                                       returnFaceAttributes=["age"])
            stage.set_col("imageUrl", "img")
            return stage, ds
        out, _ = run_both(mock, build)
        assert out["output"][0][0]["faceId"] == "f1"

    def test_verify_columns(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"a": np.array(["f1", "f1"]),
                              "b": np.array(["f1", "f2"])})
            stage = pkg.svc.VerifyFaces(url=url + "/face/verify")
            stage.set_col("faceId1", "a")
            stage.set_col("faceId2", "b")
            return stage, ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["isIdentical"] is True
        assert out["output"][1]["isIdentical"] is False


class TestFormOntology:
    def _fit_both(self, forms):
        outs, models = {}, {}
        for name, pkg in PACKAGES.items():
            ds = pkg.Dataset({"form": obj_col(forms)})
            models[name] = pkg.svc.FormOntologyLearner(
                inputCol="form", outputCol="fields").fit(ds)
            outs[name] = models[name].transform(ds)
        assert models["jax"].get("ontology") == \
            models["torch"].get("ontology")
        assert list(outs["jax"]["fields"]) == list(outs["torch"]["fields"])
        return models["torch"], outs["torch"]

    def test_nested_object_fields_projected(self):
        forms = [{"documentResults": [{"fields": {
            "Address": {"type": "object", "valueObject": {
                "City": {"type": "string", "valueString": "Redmond"},
                "Zip": {"type": "string", "valueString": "98052"}}}}}]}]
        _, out = self._fit_both(forms)
        assert out["fields"][0]["Address"] == {"City": "Redmond",
                                               "Zip": "98052"}

    def test_learn_and_project(self):
        forms = [{"documentResults": [{"fields": {
            "Total": {"type": "number", "valueNumber": 3.5},
            "Vendor": {"type": "string", "valueString": "acme"}}}]},
            {"documentResults": [{"fields": {
                "Date": {"type": "string", "valueString": "2020-01-01"}}}]}]
        model, out = self._fit_both(forms)
        assert set(model.get("ontology")) == {"Total", "Vendor", "Date"}
        assert out["fields"][0]["Vendor"] == "acme"
        assert out["fields"][1]["Date"] == "2020-01-01"


class TestTranslate:
    def test_multi_target(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["hello"])})
            return pkg.svc.Translate(url=url + "/translate",
                                     toLanguage=["fr", "de"]), ds
        out, reqs = run_both(mock, build)
        assert [t["to"] for t in out["output"][0]] == ["fr", "de"]
        assert out["output"][0][0]["text"] == "[fr] hello"
        assert reqs[0]["query"] == "to=fr&to=de"


class TestAnomaly:
    def test_simple_detect_groups_and_redistributes(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({
                "group": np.array(["a", "a", "a", "b", "b", "b"]),
                "timestamp": np.array(["t0", "t1", "t2"] * 2),
                "value": np.array([1.0, 2.0, 99.0, 5.0, 5.0, 5.0])})
            return pkg.svc.SimpleDetectAnomalies(
                url=url + "/anomaly/series", groupbyCol="group"), ds
        out, reqs = run_both(mock, build)
        assert out["output"][2]["isAnomaly"] is True
        assert out["output"][0]["isAnomaly"] is False
        assert all(v["isAnomaly"] is False for v in out["output"][3:])
        assert len(reqs) == 2

    def test_multivariate_fit_then_detect(self, mock):
        models = {}

        def build_fit(pkg, url):
            ds = pkg.Dataset({"timestamp": np.array(["t0", "t1"]),
                              "x": np.array([1.0, 20.0]),
                              "y": np.array([2.0, 30.0])})
            est = pkg.svc.FitMultivariateAnomaly(url=url + "/mvad/train",
                                                 inputCols="x,y")
            return est, ds
        for name, pkg in PACKAGES.items():
            mock.take()
            stage, ds = build_fit(pkg, mock.url)
            models[name] = (stage.fit(ds), mock.take())
        assert models["jax"][1] == models["torch"][1]
        model = models["torch"][0]
        assert isinstance(model, pt_services.DetectMultivariateAnomaly)
        assert model.modelId == "model-42"

        def build_detect(pkg, url):
            name = "jax" if pkg is PACKAGES["jax"] else "torch"
            m = models[name][0]
            m.set("url", url + "/mvad/detect")
            return m, build_fit(pkg, url)[1]
        out, _ = run_both(mock, build_detect)
        assert out["output"][0]["isAnomaly"] is False
        assert out["output"][1]["isAnomaly"] is True


class TestSearch:
    def test_add_documents_batches(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"id": np.array(["1", "2", "3"]),
                              "body": np.array(["a", "b", "c"])})
            return pkg.svc.AddDocuments(url=url + "/search/index",
                                        batchSize=2), ds
        out, reqs = run_both(mock, build, cols=("output",))
        assert list(out["output"]) == ["ok", "ok", "ok"]
        import json
        batches = [json.loads(r["body"])["value"] for r in reqs]
        assert [len(b) for b in batches] == [2, 1]
        assert batches[0][0]["@search.action"] == "upload"


class TestBingGeo:
    def test_bing_image_search(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"query": np.array(["cats"])})
            return pkg.svc.BingImageSearch(url=url + "/bing/images",
                                           count=3), ds
        out, reqs = run_both(mock, build)
        assert len(out["output"][0]) == 3
        assert out["output"][0][0]["contentUrl"].startswith("http://x/cats")
        assert reqs[0]["method"] == "GET"

    def test_point_in_polygon(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"lat": np.array([10.0, -10.0]),
                              "lon": np.array([0.0, 0.0])})
            return pkg.svc.CheckPointInPolygon(url=url + "/geo/pip"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["pointInPolygons"] is True
        assert out["output"][1]["pointInPolygons"] is False


class TestSpeech:
    def test_stt_parses_display_text(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"audio": obj_col([b"\x00" * 16])})
            return pkg.svc.SpeechToText(url=url + "/speech/stt"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0] == "heard 16 bytes"

    def test_tts_binary(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["hi <there> & 'you'"])})
            return pkg.svc.TextToSpeech(url=url + "/speech/tts"), ds
        out, reqs = run_both(mock, build)
        assert out["output"][0].startswith(b"RIFF")
        assert b"hi &lt;there&gt; &amp; 'you'" in reqs[0]["body"]


class TestTextFamilies:
    def test_language_detector(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["bonjour le monde",
                                                "hello"])})
            return pkg.svc.LanguageDetector(url=url + "/text/language"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["detectedLanguage"]["iso6391Name"] == "fr"
        assert out["output"][1]["detectedLanguage"]["iso6391Name"] == "en"

    def test_ner(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["I live in Seattle"])})
            return pkg.svc.NER(url=url + "/text/ner"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["entities"][0]["category"] == "Location"


# -- the JAX package's tests/test_io_serving.py::TestServices ---------------

class TestServices:
    def test_text_sentiment(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["good day", "awful day"])})
            return pkg.svc.TextSentiment(url=url + "/sentiment"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0]["sentiment"] == "positive"
        assert out["output"][1]["sentiment"] == "negative"

    def test_openai_prompt_templating(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(["cats", "dogs"])})
            return pkg.svc.OpenAIPrompt(url=url + "/completions",
                                        promptTemplate="say {text}!"), ds
        out, _ = run_both(mock, build)
        assert out["output"][0] == "echo: say cats!"
        assert out["output"][1] == "echo: say dogs!"

    def test_openai_completion_error_col(self, mock):
        def build(pkg, url):
            ds = pkg.Dataset({"prompt": np.array(["hi"])})
            return pkg.svc.OpenAICompletion(url="http://127.0.0.1:1/x",
                                            retries=0), ds
        out, reqs = run_both(mock, build)
        assert out["output"][0] is None
        assert out["errors"][0] is not None
        assert reqs == []


# -- beyond the JAX package's tests ----------------------------------------

class TestFailures:
    def test_injected_503_retried_and_400_in_error_col(self, mock):
        """Row 0's first attempt gets a 503 and its retry succeeds; row 1
        gets a 400, which is not retried and lands in ``errors``."""
        def build(pkg, url):
            mock.fail_next("/sentiment/f", 503, None, 400)
            ds = pkg.Dataset({"text": np.array(["good", "bad", "good"])})
            stage = pkg.svc.TextSentiment(
                url=url + "/sentiment/f",
                retryPolicy=pkg.RetryPolicy(max_retries=2, base_s=0.0))
            return stage, ds
        out, reqs = run_both(mock, build)
        assert len(reqs) == 4
        assert list(out["errors"]) == [None, "400 Bad Request", None]
        assert out["output"][0]["sentiment"] == "positive"
        assert out["output"][1] is None

    def test_grouped_anomalies_retry_and_error_col(self, mock):
        """``SimpleDetectAnomalies``: group a's 503 is retried, group b's
        400 fills ``errors`` for each of b's rows, group c is untouched."""
        def build(pkg, url):
            mock.fail_next("/anomaly/f", 503, None, 400)
            ds = pkg.Dataset({
                "group": np.array(list("aabbcc")),
                "timestamp": np.array(["t0", "t1"] * 3),
                "value": np.array([1.0, 60.0, 2.0, 3.0, 70.0, 4.0])})
            return pkg.svc.SimpleDetectAnomalies(
                url=url + "/anomaly/f", groupbyCol="group",
                retryPolicy=pkg.RetryPolicy(max_retries=2, base_s=0.0)), ds
        out, reqs = run_both(mock, build)
        assert len(reqs) == 4
        assert list(out["errors"]) == [None, None, "400 Bad Request",
                                       "400 Bad Request", None, None]
        assert [o and o["isAnomaly"] for o in out["output"]] == \
            [False, True, None, None, True, False]

    def test_shared_breaker_opens_on_the_endpoint(self, mock):
        """``breaker=True`` shares the process-wide breaker of the URL:
        after five failures it answers 503 itself and the server sees no
        more requests."""
        path = "/sentiment/breaker"

        def build(pkg, url):
            mock.fail_next(path, *([503] * 5))
            ds = pkg.Dataset({"text": np.array(["good"] * 8)})
            return pkg.svc.TextSentiment(url=url + path, retries=0,
                                         breaker=True), ds
        try:
            out, reqs = run_both(mock, build)
        finally:
            jx_drop_breaker(mock.url + path)
            pt_drop_breaker(mock.url + path)
        assert len(reqs) == 5
        errs = list(out["errors"])
        assert errs[:5] == ["503 Service Unavailable"] * 5
        assert errs[5:] == ["503 circuit breaker open"] * 3

    def test_concurrent_embeddings(self, mock):
        """``OpenAIEmbedding`` at concurrency 4: the same request set, the
        mock's vectors as float32 arrays, in row order."""
        from torch_service_mocks import embedding_of
        texts = [f"doc {i}" for i in np.random.default_rng(0).integers(
            0, 10_000, 24)]

        def build(pkg, url):
            ds = pkg.Dataset({"text": np.array(texts)})
            return pkg.svc.OpenAIEmbedding(url=url + "/embeddings",
                                           model="ada", concurrency=4), ds
        out, reqs = run_both(mock, build, concurrent=True)
        assert len(reqs) == len(texts)
        for t, v in zip(texts, out["output"]):
            assert v.dtype == np.float32
            np.testing.assert_array_equal(
                v, np.asarray(embedding_of(t, 16), np.float32))


class TestCrossLoad:
    def test_jax_saved_stage_loads_in_the_port(self, mock, tmp_path):
        """A service stage saved by the JAX package loads in the port
        (``lookup_stage`` maps the module prefix) and sends the same
        requests."""
        stage = jx_services.Translate(url=mock.url + "/translate",
                                      toLanguage=["fr"], concurrency=2)
        stage.set_col("fromLanguage", "src")
        stage.set_scalar("subscriptionKey", "k-123")
        stage.save(str(tmp_path / "t"))
        loaded = pt_load_stage(str(tmp_path / "t"))
        assert type(loaded) is pt_services.Translate
        for p in stage.params:
            assert loaded.get_or_default(p.name) == \
                stage.get_or_default(p.name), p.name
        cols = {"text": np.array(["hi", "yo"]),
                "src": np.array(["en", "es"])}
        mock.take()
        a = stage.transform(jx.Dataset(dict(cols)))
        ra = canonical(mock.take())
        b = loaded.transform(pt.Dataset(dict(cols)))
        rb = canonical(mock.take())
        assert ra == rb and len(rb) == 2
        assert rb[0]["headers"]["Ocp-Apim-Subscription-Key"] == "k-123"
        assert list(a["output"]) == list(b["output"])


# -- every service stage: the same requests and the same columns -----------

_RNG = np.random.default_rng(26)
_WORDS = np.array(["good", "bad", "bonjour", "Seattle", "x&y", "<a>"])


def _texts(n=2):
    return np.array([" ".join(_RNG.choice(_WORDS, 3)) for _ in range(n)])


def _images(stage):
    stage.set_col("imageUrl", "img")


def _image_cols():
    return {"img": np.array([f"http://a/{i}.jpg" for i in range(2)])}


#: stage name → (path, input columns, param setup, constructor params)
SWEEP = {
    **{n: ("/text/generic", lambda: {"text": _texts(), "lang":
                                     np.array(["en", "fr"])},
           lambda s: (s.set_col("language", "lang"),
                      s.set_scalar("subscriptionKey", "key")), {})
       for n in ("TextSentiment", "KeyPhraseExtractor", "LanguageDetector",
                 "EntityDetector", "NER", "PII", "AnalyzeHealthText")},
    "TextAnalyze": ("/text/generic", lambda: {"text": _texts()}, None,
                    {"tasks": ["ner", "pii"]}),
    "Translate": ("/translate", lambda: {"text": _texts(), "src":
                                         np.array(["en", "de"])},
                  lambda s: s.set_col("fromLanguage", "src"),
                  {"toLanguage": ["fr", "ja"]}),
    **{n: ("/translate", lambda: {"text": _texts()}, None, {})
       for n in ("Transliterate", "Detect", "BreakSentence",
                 "DictionaryLookup")},
    "DictionaryExamples": ("/translate", lambda: {
        "text": _texts(), "translation": _texts()}, None, {}),
    **{n: ("/vision/generic", _image_cols, _images, {})
       for n in ("DescribeImage", "OCR", "ReadImage", "TagImage",
                 "RecognizeDomainSpecificContent", "AnalyzeLayout",
                 "AnalyzeReceipts", "AnalyzeBusinessCards",
                 "AnalyzeInvoices", "AnalyzeIDDocuments")},
    "AnalyzeImage": ("/vision/analyze", _image_cols, _images,
                     {"visualFeatures": ["Tags"], "details": ["Landmarks"]}),
    "AnalyzeCustomModel": ("/vision/generic", _image_cols, _images,
                           {"modelId": "m1", "pages": "1-2",
                            "includeTextDetails": True}),
    "GenerateThumbnails": ("/vision/thumb", _image_cols, _images,
                           {"width": 32, "smartCropping": False}),
    "DetectFace": ("/face/detect", _image_cols, _images,
                   {"returnFaceLandmarks": True}),
    "FindSimilarFace": ("/face/generic", lambda: {"q": np.array(["f1",
                                                                  "f2"])},
                        lambda s: (s.set_col("faceId", "q"),
                                   s.set_scalar("faceIds", ["f3", "f4"])),
                        {"mode": "matchFace"}),
    "GroupFaces": ("/face/generic", lambda: {"x": np.arange(2)},
                   lambda s: s.set_scalar("faceIds", ["f1", "f2"]), {}),
    "IdentifyFaces": ("/face/generic", lambda: {"g": np.array(["p", "q"])},
                      lambda s: (s.set_scalar("faceIds", ["f1"]),
                                 s.set_col("personGroupId", "g"),
                                 s.set_scalar("confidenceThreshold", 0.5)),
                      {}),
    "VerifyFaces": ("/face/verify", lambda: {"a": np.array(["f1", "f1"]),
                                             "b": np.array(["f1", "f2"])},
                    lambda s: (s.set_col("faceId1", "a"),
                               s.set_col("faceId2", "b")), {}),
    **{n: ("/anomaly/series", lambda: {"series": obj_col(
        [[{"timestamp": f"t{j}", "value": float(v)}
          for j, v in enumerate(_RNG.integers(0, 100, 4))]
         for _ in range(2)])}, None, {"granularity": "hourly"})
       for n in ("DetectLastAnomaly", "DetectAnomalies")},
    "OpenAICompletion": ("/completions", lambda: {"prompt": _texts()}, None,
                         {"model": "m", "maxTokens": 7,
                          "extraBody": {"stop": ["\n"]}}),
    "OpenAIPrompt": ("/completions", lambda: {"text": _texts()}, None,
                     {"promptTemplate": "classify {text} ->",
                      "postProcessing": "csv"}),
    "OpenAIEmbedding": ("/embeddings", lambda: {"text": _texts()}, None,
                        {"model": "ada"}),
    "AddDocuments": ("/search/index", lambda: {
        "id": np.arange(5), "act": np.array(["upload", "merge", "delete",
                                             "upload", "merge"]),
        "score": _RNG.normal(size=5)}, None,
        {"actionCol": "act", "batchSize": 2}),
    **{n: ("/speech/stt", lambda: {"audio": obj_col(
        [bytes(_RNG.integers(0, 256, 12).astype(np.uint8))
         for _ in range(2)])}, None, {"language": "de-DE"})
       for n in ("SpeechToText", "ConversationTranscription")},
    "TextToSpeech": ("/speech/tts", lambda: {"text": _texts()}, None,
                     {"voiceName": "v'1"}),
    "BingImageSearch": ("/bing/images", lambda: {"query": _texts()}, None,
                        {"count": 2, "offset": 1, "imageType": "Photo"}),
    "AddressGeocoder": ("/geo/geocode", lambda: {"address": _texts()}, None,
                        {}),
    "ReverseAddressGeocoder": ("/geo/geocode", lambda: {
        "lat": _RNG.normal(size=2), "lon": _RNG.normal(size=2)}, None, {}),
    "CheckPointInPolygon": ("/geo/pip", lambda: {
        "lat": _RNG.normal(size=2), "lon": _RNG.normal(size=2)}, None,
        {"userDataIdentifier": "u1"}),
}

#: the service stages that are not transformers over one endpoint: the
#: abstract base, the grouped detector, the multivariate pair and the
#: ontology pair (each has its own tests above)
NOT_SWEPT = {"RemoteServiceTransformer", "SimpleDetectAnomalies",
             "FitMultivariateAnomaly", "DetectMultivariateAnomaly",
             "FormOntologyLearner", "FormOntologyModel"}


def test_sweep_covers_every_service_stage():
    names = {c.__name__ for q, c in JX_REGISTRY.items()
             if q.startswith("synapseml_tpu.services.")
             and not c.__name__.startswith("_")}
    assert len(names) == 51
    assert set(SWEEP) == names - NOT_SWEPT


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_every_stage_sends_the_same_requests(mock, name):
    path, make_cols, setup, params = SWEEP[name]
    cols = make_cols()

    def build(pkg, url):
        stage = getattr(pkg.svc, name)(url=url + path, **params)
        if setup is not None:
            setup(stage)
        return stage, pkg.Dataset(dict(cols))
    out_cols = ("output",) if name == "AddDocuments" else ("output",
                                                           "errors")
    out, reqs = run_both(mock, build, cols=out_cols)
    assert reqs and all(r["path"] == path for r in reqs)
    if name != "AddDocuments":
        assert all(e is None for e in out["errors"])

