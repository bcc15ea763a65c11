"""JAX's fused-attention gate in the port (segtran_tpu/nn/attention.py
:597-600): with --fused, position biases, kept scores or --multihead
each keep every cross-attention off the flash function (calls counted
with monkeypatch, eff-tiny on the CPU); kept scores carry the biases."""
import numpy as np
import pytest
import torch

from _torch_options import _configs
from _torch_parity import one_torch_thread  # noqa: F401


def _count_flash(monkeypatch):
    import segtran_tpu_torch.nn.attention as att
    calls = []
    for name in ("fused_cross_attention", "fused_cross_attention_trainable"):
        fn = getattr(att, name)

        def counted(*a, _fn=fn, **k):
            calls.append(1)
            return _fn(*a, **k)
        monkeypatch.setattr(att, name, counted)
    return calls


@pytest.mark.parametrize("option", ["none", "pos_bias", "multihead",
                                    "kept_scores"])
def test_fused_gate_is_jax(monkeypatch, option):
    """With --fused, JAX's gate (nn/attention.py:597-600): position
    biases, kept scores or --multihead keep every cross-attention off the
    flash function; without them each of the 2 layers calls it twice."""
    from segtran_tpu_torch.models.segtran2d import Segtran2d, init_segtran2d
    from segtran_tpu_torch.nn.attention import CrossAttFeatTrans
    kw = {"none": {}, "kept_scores": {},
          "pos_bias": dict(use_squeezed_transformer=False,
                           pos_code_type="bias", pos_bias_radius=2),
          "multihead": dict(ablate_multihead=True)}[option]
    _, tcfg = _configs(use_fused_attention=True, **kw)
    model = init_segtran2d(Segtran2d(tcfg), 0).eval()
    kept = [m for m in model.modules() if isinstance(m, CrossAttFeatTrans)]
    for m in kept:
        m.keep_attn_scores = option == "kept_scores"
    calls = _count_flash(monkeypatch)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        1, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        out = model(x)
    assert torch.isfinite(out).all()
    assert len(calls) == (4 if option == "none" else 0)
    if option == "kept_scores":
        assert all(m.attention_scores is not None for m in kept)
        assert kept[0].attention_scores.shape == (1, 1, 8, 64)


def test_kept_scores_carry_the_biases():
    """keep_attn_scores keeps the clamped scores plus pos_code_weight times
    the biases, as JAX sows them."""
    from segtran_tpu_torch.nn.attention import (CrossAttFeatTrans,
                                                TransLayerSpec)
    spec = TransLayerSpec(in_feat_dim=16, feat_dim=16, num_modes=2,
                          pos_code_weight=0.5,
                          attention_probs_dropout_prob=0.0,
                          hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    layer = CrossAttFeatTrans(spec, keep_attn_scores=True).eval()
    x = torch.randn(1, 6, 16)
    bias = torch.randn(1, 1, 6, 6)
    with torch.no_grad():
        layer(x)
        plain = layer.attention_scores
        layer(x, pos_biases=bias)
    torch.testing.assert_close(layer.attention_scores, plain + 0.5 * bias)
