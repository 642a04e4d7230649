"""The plain reference against the port's model, at a smoke size on the
CPU, both families, the same weights (drawn from one seed), in f32: the
logits agree at the port's CPU tolerance."""
import pytest
import torch

from skybench import modelcfg, weights
from skybench.reference import model as ref
from skybench.tests.tiny import TINY_MODEL, tiny_cell


@pytest.mark.parametrize("workload", ["stablelm-12b.rag-batch",
                                      "granite-moe-3b-a800m.rag-batch"])
def test_reference_matches_the_port(workload):
    from repro_torch.models.model import Model

    c = dict(tiny_cell(workload).config, torch_dtype="float32")
    model = Model(modelcfg.port_config(c), device="cpu")
    weights.load(model, c, 2**31 + 3)
    loaded = {n for n, _ in model.named_parameters()}
    drawn = {(g[5:] + "." if g.startswith("layer") else "") + n
             for g in weights.groups(c) for n, *_ in weights.leaves(c, g)}
    assert len(loaded) == len(drawn)
    toks = [1] + [3 + (7 * i) % 250 for i in range(60)]
    with torch.no_grad():
        lg, _ = model.forward(torch.tensor([toks]))
    got = ref.scored_logits(c, 2**31 + 3, [toks], [20], "cpu")[0]
    torch.testing.assert_close(lg[0, 19:-1], got, atol=1e-4, rtol=1e-4)


def test_reference_refuses_a_capacity_that_drops():
    c = dict(tiny_cell("granite-moe-3b-a800m.rag-batch").config,
             capacity_factor=1.25)
    with pytest.raises(ValueError, match="drop"):
        ref.scored_logits(c, 0, [[1, 5, 6]], [1], "cpu")


def test_control_rounds_coarser_than_bf16():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(64, 256, generator=g), torch.randn(256, 128,
                                                          generator=g)
    exact = x @ w
    bf16 = (x.bfloat16() @ w.bfloat16()).float()
    fp8 = ref.fp8_mm(x, w)
    assert (fp8 - exact).abs().mean() > 4 * (bf16 - exact).abs().mean()
    assert TINY_MODEL["hidden_size"] == 64
