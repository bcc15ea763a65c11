"""The redesigned ``mbconv_front`` kernel (``csrc/mbconv.cu``): its launch
plan (``_mb_plan``) at every chip-check shape and every distinct block
shape of the eff-b4 288^2 backbone (stem stride 1), in bf16 and fp32 for
an H100's 132 SMs; a plain-PyTorch emulation of its decomposition (staged
rows with zero fill, the expand per 16-deep K chunk, the halo zeroed after
swish, e rounded into a ring of k rows, taps in (ky, kx) order, SE partials
per segment summed in segment order) held against the plain version and
the JAX package's Pallas kernel in interpret mode; the CUDA wrapper's
refusals and its one launch against a stubbed library; and the operand
cache of ``MBConvBlock``."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtran_tpu_torch.kernels import _build
from segtran_tpu_torch.kernels import mbconv as mb
from segtran_tpu_torch.nn.backbones.efficientnet import build_block_specs
from test_torch_mbconv import _both, _case
from _torch_parity import one_torch_thread  # noqa: F401

SMS = 132
SMEM_MAX = 232448
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _block_shapes():
    """(label, H, spec) of each distinct block of eff-b4 at 288^2, stem
    stride 1: the five the fused-eval gate admits, two expand_ratio-1
    blocks, four stride-2 blocks and three at H18."""
    out, seen, h = [], set(), 288
    for spec in build_block_specs("eff-b4", 1)[0]:
        key = (h, spec.kernel, spec.stride, spec.in_filters,
               spec.expand_ratio)
        if key not in seen:
            seen.add(key)
            cexp = spec.in_filters * spec.expand_ratio
            out.append((f"H{h} k{spec.kernel} s{spec.stride} "
                        f"{spec.in_filters}->{cexp}", h, spec))
        h = -(-h // spec.stride)
    return out


BLOCKS = _block_shapes()


def test_the_backbone_has_fourteen_distinct_block_shapes():
    assert len(BLOCKS) == 14
    gated = [b for b in BLOCKS if b[2].stride == 1
             and b[2].expand_ratio != 1 and 36 <= b[1] <= 144]
    assert [b[0] for b in gated] == [
        "H144 k3 s1 32->192", "H72 k5 s1 56->336", "H36 k3 s1 112->672",
        "H36 k5 s1 112->672", "H36 k5 s1 160->960"]


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("label,h,spec", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_plan_fits_the_card_and_covers_every_output_once(label, h, spec,
                                                         dname, batch):
    dt = DTYPES[dname]
    cin, k, s = spec.in_filters, spec.kernel, spec.stride
    cexp = cin * spec.expand_ratio
    expand = spec.expand_ratio != 1
    plan = mb._mb_plan(batch, h, h, cin, cexp, k, s, spec.pad, dt, SMS,
                       expand)
    ho, wo = mb._out_size(h, h, k, s, spec.pad)
    es = 2 if dname == "bf16" else 4
    assert plan.cc == 128 // es
    assert plan.smem <= SMEM_MAX
    assert plan.smem == mb._smem(es, expand, plan.kp, plan.mpad, plan.wr,
                                 plan.ring)
    assert 1 <= plan.blocks_per_sm <= 2
    assert (plan.blocks_per_sm + 1) * (plan.smem + 1024) > 233472 \
        or plan.blocks_per_sm == 2
    # the ring holds the k expanded rows the taps read and the one being
    # filled, each of every column the taps read and the input fills
    pl = spec.pad[1][0]
    assert plan.ring == k + 1
    assert plan.wr >= pl + h and plan.wr >= (wo - 1) * s + k
    # bf16: K padded to the mma depth; fp32 takes it as it is
    assert (plan.kp % 16 == 0 and cin <= plan.kp < cin + 16
            if es == 2 else plan.kp == cin)
    assert plan.mpad % 16 == 0 and h <= plan.mpad < h + 16
    assert 1 <= plan.nr <= 6
    slots = 256 // (plan.cc // (4 if k == 3 else 2))
    runs = -(-wo // plan.nr)
    assert -(-runs // slots) * slots * plan.nr >= wo
    # grid (chunks, segments, B) covers every (image, output row, channel)
    # exactly once
    chunks, nseg, b = plan.grid
    assert b == batch and nseg == plan.nseg
    assert (nseg - 1) * plan.rows < ho <= nseg * plan.rows
    hits = np.zeros((ho, cexp), int)
    for c in range(chunks):
        for t in range(nseg):
            rows = slice(t * plan.rows, min(ho, (t + 1) * plan.rows))
            hits[rows, c * plan.cc:min(cexp, (c + 1) * plan.cc)] += 1
    assert (hits == 1).all()
    assert plan.waves == -(-chunks * nseg * b // (SMS * plan.blocks_per_sm))


def test_plan_pads_cin_56_and_masks_the_ragged_chunk_at_cexp_336():
    """H72 k5 56->336: K padded to 64 in bf16 (Cin 56 is not a multiple of
    the mma depth 16); Cexp 336 = 5 chunks of 64 and a ragged one of 16
    channels in bf16 (10 of 32 and one of 16 in fp32)."""
    spec = next(b[2] for b in BLOCKS if b[0] == "H72 k5 s1 56->336")
    for dt, chunks, tail, kp in ((torch.bfloat16, 6, 16, 64),
                                 (torch.float32, 11, 16, 56)):
        plan = mb._mb_plan(8, 72, 72, 56, 336, 5, 1, spec.pad, dt, SMS)
        assert plan.kp == kp
        assert plan.grid[0] == chunks
        assert 336 - (chunks - 1) * plan.cc == tail


def test_plan_refuses_a_block_over_the_cards_shared_memory():
    with pytest.raises(ValueError, match="shared memory per block"):
        mb._mb_plan(1, 64, 2048, 512, 3072, 5, 1, ((2, 2), (2, 2)),
                    torch.float32, SMS)


# ------------------------------------------------------------ emulation --

def emulate(x, w_exp, s0, b0, w_dw, s1, b1, *, kernel, stride, pad, plan):
    """The kernel's decomposition in plain PyTorch, one block at a time:
    each block (chunk, segment, image) walks its padded input rows, stages
    the row zero-filled to [mpad, kp], expands it K chunk by K chunk (fp32
    sums; the tensor core's order inside a 16-deep chunk is its own), BN0
    and swish, writes it rounded to T into ring slot (step mod ring) with
    the halo (rows and columns outside x) zero, and once k rows are in emits
    an output row: taps summed in (ky, kx) order, BN1, swish, the rounded
    output and the block's fp32 SE sums; the SE mean adds the segments'
    sums in order. (The kernel expands row i + 1 while it emits from rows
    i - k + 1 .. i; the k + 1 slots keep them apart, so the order here is
    the same computation.)"""
    dt, k, s = x.dtype, kernel, stride
    b, h, w, cin = x.shape
    cexp = w_dw.shape[-1]
    (pt, _), (pl, _) = pad
    ho, wo = mb._out_size(h, w, k, s, pad)
    cc, rows = plan.cc, plan.rows
    expand = w_exp is not None
    f = torch.float32
    wq = F.pad(w_dw.float(), (0, -cexp % cc))
    s1q, b1q = (F.pad(t.float(), (0, -cexp % cc)) for t in (s1, b1))
    if expand:
        w_chunk = torch.zeros(plan.kp, cexp + -cexp % cc)
        w_chunk[:cin, :cexp] = w_exp.to(dt).float()
        s0q, b0q = (F.pad(t.float(), (0, -cexp % cc)) for t in (s0, b0))
    out = torch.zeros(b, ho, wo, cexp, dtype=dt)
    part = torch.zeros(b, plan.nseg, cexp)
    for bi in range(b):
        for seg in range(plan.nseg):
            oy0 = seg * rows
            nin = (min(rows, ho - oy0) - 1) * s + k
            for c0 in range(0, cexp, cc):
                c1 = min(c0 + cc, cexp)
                ring = torch.zeros(plan.ring, plan.wr, cc)
                se = torch.zeros(cc)
                for i in range(nin):
                    ih = oy0 * s - pt + i
                    row = torch.zeros(plan.wr, cc)
                    if 0 <= ih < h and expand:
                        xs = torch.zeros(plan.mpad, plan.kp)
                        xs[:w, :cin] = x[bi, ih].float()
                        acc = torch.zeros(plan.mpad, cc)
                        for k0 in range(0, plan.kp, 16):
                            acc = acc + xs[:, k0:k0 + 16] @ \
                                w_chunk[k0:k0 + 16, c0:c0 + cc]
                        e = F.silu(acc * s0q[c0:c0 + cc] + b0q[c0:c0 + cc])
                        row[pl:pl + w] = e[:w].to(dt).float()
                    elif 0 <= ih < h:
                        row[pl:pl + w, :c1 - c0] = x[bi, ih, :, c0:c1].float()
                    ring[i % plan.ring] = row
                    j = i - (k - 1)
                    if j < 0 or j % s:
                        continue
                    acc = torch.zeros(wo, cc, dtype=f)
                    for ky in range(k):
                        r = ring[(i - (k - 1) + ky) % plan.ring]
                        for kx in range(k):
                            acc = acc + r[kx:kx + (wo - 1) * s + 1:s] * \
                                wq[ky, kx, c0:c0 + cc]
                    y = F.silu(acc * s1q[c0:c0 + cc] + b1q[c0:c0 + cc])
                    out[bi, oy0 + j // s, :, c0:c1] = y[:, :c1 - c0].to(dt)
                    se = se + y.sum(0)
                part[bi, seg, c0:c1] = se[:c1 - c0]
    total = torch.zeros(b, cexp)
    for seg in range(plan.nseg):
        total = total + part[:, seg]
    return out, total / float(ho * wo)


def _torch_args(args, dt):
    typed = {0, 1, 4}
    return [None if a is None else
            torch.from_numpy(a).to(dt if i in typed else torch.float32)
            for i, a in enumerate(args)]


def _plan_with_rows(x, args, k, stride, pad, rows):
    b, h, w, cin = x.shape
    cexp = args[4].shape[-1]
    plan = mb._mb_plan(b, h, w, cin, cexp, k, stride, pad, x.dtype, SMS,
                       args[1] is not None)
    ho = mb._out_size(h, w, k, stride, pad)[0]
    rows = min(rows, ho)
    return plan._replace(rows=rows, nseg=-(-ho // rows))


# (k, stride, expand) of test_torch_mbconv's cases; segments of 1, 5 and
# all output rows
CASES = [(3, 1, True), (3, 2, True), (5, 1, True), (5, 2, True),
         (3, 1, False)]


@pytest.mark.parametrize("rows", [1, 5, 12])
@pytest.mark.parametrize("k,stride,expand", CASES)
def test_emulation_equals_the_plain_version_fp32(k, stride, expand, rows):
    """fp32: the emulation sums the same products in another order
    (16-deep K chunks, segment partials): 1e-6."""
    args, pad = _case(k, stride, expand, seed=k * 10 + stride)
    targs = _torch_args(args, torch.float32)
    plan = _plan_with_rows(targs[0], targs, k, stride, pad, rows)
    got, se = emulate(*targs, kernel=k, stride=stride, pad=pad, plan=plan)
    want, se_want = mb.mbconv_front_reference(*targs, kernel=k,
                                              stride=stride, pad=pad)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(se, se_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,stride,expand", CASES)
def test_emulation_matches_the_plain_version_bf16(k, stride, expand):
    """bf16: both round e and the output to bf16 at the same points, but
    the expand's fp32 sums run in other orders, which can move e across a
    bf16 rounding boundary: one bf16 ulp (2^-8 relative) of e, carried
    through the taps, and one of the output; 2^-7 of (1 + |plain|). The SE
    mean is taken over fp32 values on both sides."""
    args, pad = _case(k, stride, expand, seed=k * 10 + stride)
    targs = _torch_args(args, torch.bfloat16)
    plan = _plan_with_rows(targs[0], targs, k, stride, pad, 5)
    got, se = emulate(*targs, kernel=k, stride=stride, pad=pad, plan=plan)
    want, se_want = mb.mbconv_front_reference(*targs, kernel=k,
                                              stride=stride, pad=pad)
    err = (got.float() - want.float()).abs() / (1 + want.float().abs())
    assert float(err.max()) <= 2 ** -7
    torch.testing.assert_close(se, se_want, rtol=2e-3, atol=2e-3)


def test_emulation_at_cin_56_and_a_ragged_chunk():
    """Cin 56 (K padded to 64) and Cexp 336 (a ragged last chunk), k 5,
    segments of 4 rows, fp32: 1e-6 of the plain version."""
    rng = np.random.RandomState(7)
    b, h, w, cin, cexp, k = 1, 9, 11, 56, 336, 5
    pad = ((2, 2), (2, 2))
    args = [rng.randn(b, h, w, cin).astype(np.float32),
            (rng.randn(cin, cexp) * 0.15).astype(np.float32),
            (rng.rand(cexp) + 0.5).astype(np.float32),
            (rng.randn(cexp) * 0.1).astype(np.float32),
            (rng.randn(k, k, cexp) * 0.2).astype(np.float32),
            (rng.rand(cexp) + 0.5).astype(np.float32),
            (rng.randn(cexp) * 0.1).astype(np.float32)]
    targs = _torch_args(args, torch.float32)
    plan = _plan_with_rows(targs[0], targs, k, 1, pad, 4)
    assert plan.kp == 56 and cexp % plan.cc
    got, se = emulate(*targs, kernel=k, stride=1, pad=pad, plan=plan)
    want, se_want = mb.mbconv_front_reference(*targs, kernel=k, stride=1,
                                              pad=pad)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(se, se_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,stride,expand", [(3, 2, True), (5, 1, True),
                                             (3, 1, False)])
def test_emulation_matches_the_jax_kernel(k, stride, expand):
    """The emulation against JAX's Pallas kernel in interpret mode (fp32,
    1e-5: both sum the same products in other orders)."""
    args, pad = _case(k, stride, expand, seed=k * 10 + stride)
    (jdw, jse), _ = _both(args, k, stride, pad, jnp.float32, torch.float32)
    targs = _torch_args(args, torch.float32)
    plan = _plan_with_rows(targs[0], targs, k, stride, pad, 5)
    got, se = emulate(*targs, kernel=k, stride=stride, pad=pad, plan=plan)
    np.testing.assert_allclose(got.numpy(), jdw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(se.numpy(), jse, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the CUDA wrapper --

def _without_a_card(monkeypatch):
    """The wrapper as on a CUDA tensor, with neither a library nor a plain
    version to run."""
    monkeypatch.setattr(mb, "_on_cpu", lambda t: False)
    monkeypatch.setattr(mb, "_lib", lambda: None)
    monkeypatch.setattr(mb, "_sm_count", lambda device: SMS)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(mb, "mbconv_front_reference", refuse)


def _args(b=2, h=12, w=20, cin=16, cexp=96, k=3, dt=torch.bfloat16):
    """Operands in the kernel's types (w_exp in dt, the rest fp32)."""
    return [torch.zeros(b, h, w, cin, dtype=dt), torch.zeros(cin, cexp,
                                                             dtype=dt),
            torch.ones(cexp), torch.zeros(cexp), torch.zeros(k, k, cexp),
            torch.ones(cexp), torch.zeros(cexp)]


PAD3 = ((1, 1), (1, 1))


@pytest.mark.parametrize("what", ["k7", "stride3", "fp16", "cin12",
                                  "x 4 bytes off", "row stride 12",
                                  "no expand, cin != cexp", "w_dw shape",
                                  "w_exp 4 bytes off"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                            what):
    """Each raises ValueError before any launch: k other than 3 or 5, a
    stride other than 1 or 2, a type other than bf16 or fp32, Cin or x's
    row strides not whole 16-byte vectors, x or w_exp off a 16-byte
    boundary, mismatched weights."""
    _without_a_card(monkeypatch)
    args, kw = _args(), dict(kernel=3, stride=1, pad=PAD3)
    if what == "k7":
        kw["kernel"] = 7
    elif what == "stride3":
        kw["stride"] = 3
    elif what == "fp16":
        args[0] = args[0].half()
    elif what == "cin12":
        args = _args(cin=12)
    elif what == "x 4 bytes off":
        args[0] = torch.zeros(args[0].numel() + 2, dtype=torch.bfloat16)[
            2:].view(args[0].shape)
    elif what == "row stride 12":
        args[0] = torch.zeros(2, 12, 20, 28, dtype=torch.bfloat16)[..., :16]
    elif what == "no expand, cin != cexp":
        args[1] = args[2] = args[3] = None
    elif what == "w_dw shape":
        args[4] = torch.zeros(5, 5, 96)
    elif what == "w_exp 4 bytes off":
        args[1] = torch.zeros(16 * 96 + 2, dtype=torch.bfloat16)[2:].view(
            16, 96)
    launches = mb.mbconv_front.launches
    with pytest.raises(ValueError):
        mb.mbconv_front(*args, **kw)
    assert mb.mbconv_front.launches == launches


class _Lib:
    def __init__(self):
        self.calls = []

    def mbconv_front(self, *a):
        self.calls.append(a)
        return 0


def _stub(monkeypatch):
    _without_a_card(monkeypatch)
    lib = _Lib()
    monkeypatch.setattr(mb, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    return lib


@pytest.mark.parametrize("dname", list(DTYPES))
def test_cuda_wrapper_launches_once_at_the_plan_without_copies(monkeypatch,
                                                               dname):
    """One call of the C entry with x by its strides (an NHWC view of
    channels-last memory), operands already in the kernel's types passed
    as they are (no copy), the shape, the pads and the plan's segment rows
    and run length; outputs [B, Ho, Wo, Cexp] and the SE mean [B, Cexp]
    from the call itself (no sum or divide after it); one launch
    counted."""
    lib = _stub(monkeypatch)
    dt = DTYPES[dname]
    args = _args(dt=dt)
    args[0] = torch.zeros(2, 16, 12, 20, dtype=dt).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    launches = mb.mbconv_front.launches
    out, se = mb.mbconv_front(*args, kernel=3, stride=1, pad=PAD3)
    assert mb.mbconv_front.launches == launches + 1
    assert out.shape == (2, 12, 20, 96) and out.dtype == dt
    assert se.shape == (2, 96) and se.dtype == torch.float32
    (a,) = lib.calls
    assert a[:7] == (int(dt == torch.bfloat16), 3, 1, args[0].data_ptr(),
                     *args[0].stride()[:3])
    assert list(a[7:13]) == [t.data_ptr() for t in args[1:]]
    assert a[14] % 16 == 0 and a[15] == se.data_ptr()
    assert a[13] == out.data_ptr()
    plan = mb._mb_plan(2, 12, 20, 16, 96, 3, 1, PAD3, dt, SMS)
    assert a[16:] == (2, 12, 20, 16, 96, 1, 1, 12, 20, plan.rows, plan.nr, 7)


def test_cuda_wrapper_pads_a_ragged_cexp_to_whole_vectors(monkeypatch):
    """Cexp 20 in bf16 (not a whole number of 8-value vectors): the kernel
    runs at Cexp 24 with zero weights in the extra channels, and the
    results are the first 20 channels."""
    lib = _stub(monkeypatch)
    args = _args(cexp=20)
    out, se = mb.mbconv_front(*args, kernel=3, stride=1, pad=PAD3)
    assert out.shape == (2, 12, 20, 20) and se.shape == (2, 20)
    (a,) = lib.calls
    assert a[20] == 24


def test_cuda_wrapper_without_an_expand(monkeypatch):
    """expand_ratio 1: null w_exp and BN0, Cexp == Cin."""
    lib = _stub(monkeypatch)
    args = _args(cexp=16, k=5)
    args[1] = args[2] = args[3] = None
    out, _ = mb.mbconv_front(*args, kernel=5, stride=2, pad=((1, 2), (1, 2)))
    assert out.shape == (2, 6, 10, 16)
    (a,) = lib.calls
    assert a[1:3] == (5, 2) and a[7:10] == (None, None, None)


def test_ablation_edits_all_apply_to_the_source():
    """tools/ablate_mbconv.py builds variants of the kernel's source by
    text replacement: every text it replaces must still be in it."""
    from segtran_tpu_torch.tools import ablate_mbconv
    src = _build.source_text("mbconv")
    for name, edits in ablate_mbconv.VARIANTS.items():
        for old, _ in edits:
            assert old in src, f"variant '{name}': {old!r} not found"


# ------------------------------------------------------- operand cache --

def _block(seed=0):
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        MBConvBlock, _BlockSpec)
    spec = _BlockSpec(kernel=3, stride=1, expand_ratio=6, in_filters=8,
                      out_filters=8, se_ratio=0.25, pad=((1, 1), (1, 1)))
    torch.manual_seed(seed)
    blk = MBConvBlock(spec, fused_eval=True)
    with torch.no_grad():
        for bn in (blk._bn0, blk._bn1, blk._bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    return blk.eval()


X36 = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 36, 36).astype(
    np.float32))


def _unfused(blk, x):
    blk.fused_eval = False
    try:
        return blk(x)
    finally:
        blk.fused_eval = True


def test_operand_cache_is_reused_across_eval_calls(monkeypatch):
    """Two eval forwards build the kernel operands once; the second gives
    the same output bit for bit, and both equal the unfused block (1e-5:
    fp32, other summation orders)."""
    blk = _block()
    calls = []
    real = mb.mbconv_front
    monkeypatch.setattr(
        "segtran_tpu_torch.nn.backbones.efficientnet.mbconv_front",
        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    with torch.inference_mode():
        first = blk(X36)
        ops = blk._front_cache[2]
        second = blk(X36)
    assert len(calls) == 2 and blk._front_cache[2] is ops
    assert all(a is b for a, b in zip(calls[0][1:], calls[1][1:]))
    assert not any(t.requires_grad or t.is_inference() for t in ops)
    assert torch.equal(first, second)
    torch.testing.assert_close(first, _unfused(blk, X36), rtol=1e-5,
                               atol=1e-5)
    w_exp, s0, b0, w_dw, s1, b1 = ops
    assert w_exp.shape == (8, 48) and w_dw.shape == (3, 3, 48)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in ops)


def test_operand_cache_rebuilds_after_load_state_dict():
    blk, other = _block(0), _block(1)
    with torch.no_grad():
        blk(X36)
        ops = blk._front_cache[2]
        blk.load_state_dict(other.state_dict())
        got = blk(X36)
    assert blk._front_cache[2] is not ops
    torch.testing.assert_close(got, other(X36), rtol=0, atol=0)


@pytest.mark.parametrize("edit", ["bn1 running_var", "bn0 weight",
                                  "expand weight", "depthwise weight"])
def test_operand_cache_rebuilds_after_an_in_place_edit(edit):
    blk = _block()
    with torch.no_grad():
        before = blk(X36)
        ops = blk._front_cache[2]
        {"bn1 running_var": lambda: blk._bn1.running_var.mul_(2.0),
         "bn0 weight": lambda: blk._bn0.weight.add_(0.5),
         "expand weight": lambda: blk._expand_conv.weight.mul_(-1.0),
         "depthwise weight": lambda: blk._depthwise_conv.weight.add_(0.1),
         }[edit]()
        got = blk(X36)
    assert blk._front_cache[2] is not ops
    assert not torch.equal(got, before)
    torch.testing.assert_close(got, _unfused(blk, X36), rtol=1e-5, atol=1e-5)


def test_operand_cache_rebuilds_after_a_buffer_is_replaced():
    """A BatchNorm buffer assigned a new tensor (here one of the same
    version 0 and values of its own) is a new source: the cache is
    rebuilt."""
    blk = _block()
    with torch.no_grad():
        blk(X36)
        ops = blk._front_cache[2]
        blk._bn1.running_var = torch.full_like(blk._bn1.running_var, 2.0)
        got = blk(X36)
    assert blk._front_cache[2] is not ops
    torch.testing.assert_close(got, _unfused(blk, X36), rtol=1e-5, atol=1e-5)


def test_operand_cache_rebuilds_after_a_dtype_or_device_change():
    """.to(dtype) and .to(device) replace the parameters' data in place
    (same tensors, other dtype or device): the cache follows both (the
    device here is 'meta', the one a CPU-only run can move to)."""
    blk = _block()
    with torch.no_grad():
        want = blk(X36)
        ops = blk._front_cache[2]
        blk.to(torch.float64)
        assert blk._front_operands()[3].dtype == torch.float32
        assert blk._front_cache[2] is not ops
        blk.to(torch.float32)
        torch.testing.assert_close(blk(X36), want, rtol=0, atol=0)
        blk.to("meta")
        assert all(t.device.type == "meta" for t in blk._front_operands())


def test_operand_cache_is_not_kept_for_inference_tensors():
    """A block built under inference_mode holds inference tensors, which
    have no version counter: its operands are made anew on each call, and
    the output still equals the unfused block's."""
    with torch.inference_mode():
        blk = _block()
        got = blk(X36)
        assert blk._front_cache is None
        torch.testing.assert_close(got, _unfused(blk, X36), rtol=1e-5,
                                   atol=1e-5)


def test_fused_backbone_output_is_unchanged_by_the_cache():
    """eff-b0 at stem stride 1 and 72^2 (one block inside the gate): the
    second forward (operands from the cache) equals the first bit for bit,
    and a forward after dropping every cache equals both."""
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures, MBConvBlock)
    torch.manual_seed(0)
    net = EfficientNetFeatures("eff-b0", stem_stride=1, fused_eval=True).eval()
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 72, 72, 3).astype(
        np.float32))
    with torch.no_grad():
        first = net(x)
        cached = [m for m in net.modules() if isinstance(m, MBConvBlock)
                  and m._front_cache is not None]
        second = net(x)
        for m in cached:
            m._front_cache = None
        third = net(x)
    assert len(cached) == 1
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)
