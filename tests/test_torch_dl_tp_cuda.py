"""Model parallelism over a gang on the card: phase 29 of chip_smoke.py
(29a tensor-parallel training, 29b the tensor-parallel Llama's
``generate``, 29c ring attention, 29d the GPipe pipeline) at a small size,
two gloo ranks sharing the card against one process on it, with
phase 29's limits.  Marked ``gpu``: every test skips where no card is
present.  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_dl_tp_cuda.py
"""

import pytest
import torch

import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

#: phase 29 at the tiny widths: 2 encoder layers of d 64 (4 for the
#: pipeline), the Llama at d 64 with 2 layers, ring attention over 1024
#: tokens
SMALL = dict(
    P29_TEXT=dict(cfg=dict(vocab_size=512, max_len=32, num_layers=2,
                           num_heads=4, d_model=64, d_ff=128, num_classes=2,
                           dropout_rate=0.1), batch=8, steps=3, lr=1e-4),
    P29_LLAMA=dict(cfg=dict(max_len=32, d_model=64, num_layers=2,
                            num_heads=4, num_kv_heads=2, d_ff=128,
                            vocab_size=512), prompts=2, prompt_len=8, new=4),
    P29_RING=dict(B=1, S=1024, H=4, D=16),
    P29_PIPE=dict(cfg=dict(vocab_size=512, max_len=32, num_layers=4,
                           num_heads=4, d_model=64, d_ff=128, num_classes=2,
                           dropout_rate=0.0), stages=2, micro=4, mb=2))


@pytest.fixture(scope="module")
def phase29():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang shares it")
    import chip_smoke
    return chip_smoke.model_parallel(0, torch.device("cuda", 0),
                                     chip_smoke.gpu_line(), sizes=SMALL)


def test_tensor_parallel_training_equals_one_process(phase29):
    a = phase29["a"]
    assert a["loss_rel"] <= 1e-5 and a["param_diff"] <= 1e-5
    assert a["allreduces_per_step"] > 0


def test_tensor_parallel_generate_equals_one_process(phase29):
    b = phase29["b"]
    assert b["logit_diff"] <= 1e-4
    assert b["tokens_equal"] or b["divergence"]["top2_gap"] < 1e-4


def test_ring_attention_on_the_card(phase29):
    assert max(phase29["c"]["err"].values()) <= 2e-5


def test_pipeline_on_the_card(phase29):
    d = phase29["d"]
    assert d["loss_rel"] <= 5e-5 and d["grad_share"] <= 1.0
