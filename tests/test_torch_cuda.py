"""The Hopper kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU with nvcc
and skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance (as in chip_smoke.py): in bf16, every row's cosine >= 0.9999 and
>= 99% of elements within 2 bf16 ULPs of the plain version, which differs
only in summation order; in fp32, max |kernel - plain| / max(|plain|, 1)
<= 1e-5 (summation order of fp32 sums over 64 dims and S keys). The six
LoRA cotangents of the text-block backward are sums over all B*S rows:
fp32 max |kernel - plain| <= 1e-5 * max |plain| per factor, bf16 cosine
>= 0.9999 per factor. The text-block kernels' bf16 outputs go through a
chain of eleven bf16 roundings, so their bar is per row (as in
chip_smoke.py): cosine >= 0.9999 and every element within 2 bf16 ULPs of the
row's largest |plain| value. The bf16 tensor-core attention core of rows 7
and 8 takes the bf16 bar at its tile edges, on the rows the mask leaves keys
in; a row the mask removes whole is exactly zero in kernel and plain
version; row 8 gives the same output bit for bit at every head group, and at
hg=H row 7's. fp32 rows 7 and 6 at D=64 run the register-tiled core and
take the fp32 bar at its tile edges, row 6 bit for bit row 7 (one body on
two layouts); its scalar predecessor (row 7's private scalar form) holds the
same bar. The attention-core backward (row 9) takes the
fp32 bar above and the bf16 one; its two scalar fp32 forms on the card (one
tile, two streaming passes) agree bit for bit. Its bf16 tensor-core form at
the tile edges takes the per-row bar of the text-block kernels on every row
of the cotangent that is not all zero (at S=1, dq and dk are the fp32
rounding noise of ds = p (dp - p dp) with p = 1, in kernel and plain version
alike), and those rows are zero in the kernel too; its fp32 register-tiled
form (the fp32 route) takes the fp32 bar at its tile edges, the same rows
zero. Row 6 in bf16 at D=64 runs the
tensor-core core of rows 7-8 and takes the bf16 bar at its tile edges;
which kernels each route launches is read from the profiler's trace. The
probe's int8 body is exact in both its forms (wgmma, the route, and WMMA),
its bf16 and quantized bodies take the bf16 bar (fp32 sums in another order
before one bf16 rounding). The kernel-experiment variants (rows 15-16)
take the bf16 bar in both forms (form 0, the stage and the tensor-core
variant core, at B = 2 and 64; form 1, the WMMA design, at B = 2), rows that
are zero in the plain version equal; maconly is exact (integer products and
one fp32 add), the three schedules of kernel_experiments5.py give row 1's
form 0 output bit for bit and gelu2 row 2's.
Rows 1 and 2 run their products on the wgmma GEMM stage and row 1's core on
the tensor-core core: their int8 products are exact in int32 and their
epilogues are the WMMA form's, so row 2 and row 1's QKV stage equal the
WMMA forms bit for bit, and each int8 product of the stage alone equals the
WMMA stage bit for bit; rows 1 and 2 and the bf16 out-projection take the
bf16 bar against their plain versions. Rows 3 and 4 run on the same stage
(row 3's c_proj folding the chunk sums, EpiChunkResidual): row 3's form 0
equals its WMMA form 1 bit for bit, row 4's form 0 equals rows 1 and 2 (or
3) in turn, its form 1 the WMMA rows in turn; the folded c_proj alone takes
the bf16 bar against its plain version; a chunk of the hidden axis that is
not a whole number of 128-deep K-slices is refused before a launch. Rows 5
and 10 (bf16) run their products on the same stage and row 5's core on the
tensor-core core (form 0): they sum fp32 in another order than their WMMA
form 1, so each takes the bf16 bar against its plain version and against
form 1, and repeats itself bit for bit; the bf16 engines' image chunks
launch the stage and the tensor-core core and no WMMA GEMM or scalar core.
Rows 11-14 (the training text block, bf16 and int8) run form 0: their
backbone products on the same stage (bf16 with a K-major B for the
backward's g . W^T, row 14's chunked dh2 product with its chunk sums
folded) and their core backward on row 9's tensor-core passes (fp32 store
for int8). Forms 0 and 1 each hold the text-block bars against the plain
version and against each other (the int8 forward bit for bit); the
backwards launch the stage and the tensor-core passes and no WMMA GEMM or
block_core_bwd_kernel, and repeat themselves bit for bit; the fold alone is
form 1's split product plus its in-order sum bit for bit, the stage's int8
A @ B^T its WMMA form; fp32 rows 11-12 keep their SIMT route.
"""

import re

import numpy as np
import pytest
import torch

from aiic_tpu_torch.models import clip
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import _build, attention, block_grad, mlp, quant
from aiic_tpu_torch.probes import kernel_experiments, mxu_probe, variants

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(device, bsz, seq, width, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, dtype=torch.float32):
        a = (rng.standard_normal(shape) * std).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    x = t(bsz, seq, width, dtype=torch.bfloat16)
    wqkv_q, sqkv = quant.quantize_weight(t(width, 3 * width, std=width ** -0.5))
    w1_q, s1 = quant.quantize_weight(t(width, 4 * width, std=(2 * width) ** -0.5))
    w2_q, s2 = quant.quantize_weight(t(4 * width, width, std=0.01))
    ln = (1 + t(width, std=0.1), t(width, std=0.1))
    attn = (*ln, wqkv_q, sqkv, t(3 * width, std=0.1), t(width, width, std=0.01, dtype=torch.bfloat16),
            t(width, std=0.1))
    mlp = (*ln, w1_q, s1, t(4 * width, std=0.1), w2_q, s2, t(width, std=0.1))
    return x, attn, mlp


def _agree(out, ref):
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((o - r).abs() <= 2 * ulp).float().mean() >= 0.99
    assert torch.nn.functional.cosine_similarity(o, r, dim=-1).min() >= 0.9999


@pytest.mark.parametrize("shape", [(2, 197, 768, 12, False), (4, 77, 512, 8, True)],
                         ids=["image", "text_causal"])
def test_int8_attention_kernel_matches_plain(device, shape):
    bsz, seq, width, heads, masked = shape
    x, attn, _ = _inputs(device, bsz, seq, width)
    mask = causal_mask(seq, device=device) if masked else None
    before = quant.int8_ln_qkv_attention.launches
    out = quant.int8_ln_qkv_attention(x, *attn, mask, heads=heads)
    torch.cuda.synchronize()
    assert quant.int8_ln_qkv_attention.launches == before + 1
    _agree(out, quant.int8_ln_qkv_attention_ref(x, *attn, mask, heads=heads))


@pytest.mark.parametrize("shape", [(2, 197, 768), (4, 77, 512)], ids=["image", "text"])
def test_int8_mlp_kernel_matches_plain(device, shape):
    x, _, mlp = _inputs(device, *shape)
    before = quant.int8_ln_mlp.launches
    out = quant.int8_ln_mlp(x, *mlp)
    torch.cuda.synchronize()
    assert quant.int8_ln_mlp.launches == before + 1
    _agree(out, quant.int8_ln_mlp_ref(x, *mlp))


def test_kernels_refuse_what_they_do_not_take(device):
    x, attn, mlp = _inputs(device, 1, 17, 768)
    with pytest.raises(TypeError):
        quant.int8_ln_mlp(x.float(), *mlp)
    with pytest.raises(ValueError):
        quant.int8_ln_qkv_attention(x, *attn, heads=16)  # head_dim 48


def _agree_rows(out, ref):
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    rmax = r.abs().amax(dim=-1, keepdim=True).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(rmax)) - 7)
    assert bool(((o - r).abs() <= 2 * ulp).all())
    assert torch.nn.functional.cosine_similarity(o, r, dim=-1).min() >= 0.9999


def _f32_agree(out, ref):
    assert out.dtype == ref.dtype == torch.float32
    assert float(((out - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 1e-5


def _core_qkv(device, bsz, seq, width, heads, kind, dtype, seed=1):
    """(B, S, 3W) packed qkv, the mask and the rows every key of which the
    mask removes, for a core test of ``kind``: False (no mask), True
    (causal), "dead_row" (causal with rows 0 and S-1 all -inf: a zero row)
    or "clamp" (query row 0 of every head scaled by 100, so its scores pass
    the 70 log2 e clamp)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bsz, seq, 3 * width)).astype(np.float32)
    if kind == "clamp":
        a[:, 0, :width] *= 100.0
    mask, dead = None, []
    if kind in (True, "dead_row"):
        mask = causal_mask(seq, device=device)
    if kind == "dead_row":
        dead = sorted({0, seq - 1})
        mask[dead] = float("-inf")
    return torch.from_numpy(a).to(device=device, dtype=dtype), mask, dead


def _core_agree(out, ref, dead):
    """The bar of the dtype on the live rows; rows the mask removes whole
    are exactly zero in the kernel and in the plain version."""
    assert bool(torch.isfinite(out.float()).all())
    live = [i for i in range(out.shape[1]) if i not in dead]
    if dead:
        assert bool((out[:, dead] == 0).all()) and bool((ref[:, dead] == 0).all())
    if live:
        o, r = out[:, live], ref[:, live]
        _f32_agree(o, r) if out.dtype == torch.float32 else _agree(o, r)


# (B, S, W, H, mask kind): the bf16 tensor-core core's tile edges (64 query
# rows a block, 64-key tiles), the L/14 text and image shapes, a row the
# mask removes whole, a row whose scores pass the clamp.
CORE_EDGES = [(b, s, 256, 4, False) for s in (1, 13, 63, 64, 65, 197, 577) for b in (1, 3)] + [
    (1, 77, 256, 4, True), (3, 77, 768, 12, True), (1, 257, 1024, 16, False),
    (3, 257, 1024, 16, False), (3, 77, 512, 8, "dead_row"), (2, 130, 256, 4, "dead_row"),
    (2, 197, 768, 12, "clamp"), (1, 577, 256, 4, "clamp")]
CORE_CASES = ([pytest.param(s, torch.bfloat16, id=f"bf16_B{s[0]}_S{s[1]}_W{s[2]}_{s[4]}")
               for s in CORE_EDGES]
              + [pytest.param(s, torch.float32, id=f"fp32_B{s[0]}_S{s[1]}_{s[4]}")
                 for s in [(1, 1, 256, 4, False), (3, 64, 256, 4, False), (3, 65, 256, 4, True),
                           (2, 130, 256, 4, "dead_row"), (2, 197, 768, 12, "clamp")]])


@pytest.mark.parametrize("shape,dtype", [
    pytest.param(s, d, id=f"{i}-{n}") for s, i in ((
        (2, 197, 768, 12, False), "image"), ((4, 77, 512, 8, True), "text_causal"))
    for d, n in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))] + CORE_CASES)
def test_attention_qkv_kernel_matches_plain(device, shape, dtype):
    """Row 7 against its plain version: fp32 on the register-tiled core at 1e-5, bf16
    on the tensor-core core at the bf16 bar, at the serving shapes and the
    new core's tile edges; all-masked rows zero, clamped rows finite."""
    bsz, seq, width, heads, kind = shape
    qkv, mask, dead = _core_qkv(device, bsz, seq, width, heads, kind, dtype)
    before = attention.fused_attention_qkv.launches
    out = attention.fused_attention_qkv(qkv, mask, heads=heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv.launches == before + 1
    _core_agree(out, attention.fused_attention_qkv_ref(qkv, mask, heads), dead)


@pytest.mark.parametrize("shape", [(2, 197, 768, 12, False), (4, 77, 512, 8, True)],
                         ids=["image", "text_causal"])
def test_ln_qkv_attention_kernel_matches_plain(device, shape):
    bsz, seq, width, heads, masked = shape
    x, attn, _ = _inputs(device, bsz, seq, width)
    ln_s, ln_b = attn[:2]
    rng = np.random.default_rng(2)
    wqkv = torch.from_numpy((rng.standard_normal((width, 3 * width)) * width ** -0.5)
                            .astype(np.float32)).to(device)
    args = (x, ln_s, ln_b, wqkv, *attn[4:])
    mask = causal_mask(seq, device=device) if masked else None
    before = attention.fused_ln_qkv_attention.launches
    out = attention.fused_ln_qkv_attention(*args, mask, heads=heads)
    torch.cuda.synchronize()
    assert attention.fused_ln_qkv_attention.launches == before + 1
    _agree(out, attention.fused_ln_qkv_attention_ref(*args, mask, heads=heads))


@pytest.mark.parametrize("shape", [(2, 197, 768), (4, 77, 512)], ids=["image", "text"])
def test_ln_mlp_kernel_matches_plain(device, shape):
    x, _, mlp_args = _inputs(device, *shape)
    width = shape[-1]
    rng = np.random.default_rng(3)
    w = lambda *s, std: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32)).to(device)  # noqa: E731
    args = (x, *mlp_args[:2], w(width, 4 * width, std=(2 * width) ** -0.5), mlp_args[4],
            w(4 * width, width, std=0.01), mlp_args[7])
    before = mlp.fused_ln_mlp.launches
    out = mlp.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert mlp.fused_ln_mlp.launches == before + 1
    _agree(out, mlp.fused_ln_mlp_ref(*args))


@pytest.mark.parametrize("kernel", ["fused_attention_qkv", "fused_ln_qkv_attention",
                                    "fused_ln_mlp"])
def test_new_kernels_refuse_what_they_do_not_take(device, kernel):
    """A CUDA tensor of a shape or type the kernel does not take raises; it
    never falls back to the plain version."""
    x, attn, mlp_args = _inputs(device, 1, 17, 768)
    before = getattr(attention if kernel != "fused_ln_mlp" else mlp, kernel).launches
    if kernel == "fused_attention_qkv":
        qkv = torch.zeros((1, 17, 3 * 768), device=device)
        with pytest.raises(ValueError):
            attention.fused_attention_qkv(qkv, heads=16)  # head_dim 48
        with pytest.raises(TypeError):
            attention.fused_attention_qkv(qkv.half(), heads=12)
    elif kernel == "fused_ln_qkv_attention":
        wqkv = torch.zeros((768, 3 * 768), device=device)
        args = (x, *attn[:2], wqkv, *attn[4:])
        with pytest.raises(ValueError):
            attention.fused_ln_qkv_attention(*args, heads=16)  # head_dim 48
        with pytest.raises(TypeError):
            attention.fused_ln_qkv_attention(x.float(), *args[1:], heads=12)
        with pytest.raises(ValueError):  # a weight on another device
            attention.fused_ln_qkv_attention(x, *attn[:2], wqkv.cpu(), *attn[4:], heads=12)
    else:
        w1 = torch.zeros((768, 3000), device=device)
        w2 = torch.zeros((3000, 768), device=device)
        with pytest.raises(ValueError):  # hidden width not a multiple of 128
            mlp.fused_ln_mlp(x, *mlp_args[:2], w1, torch.zeros(3000), w2, mlp_args[7])
        with pytest.raises(TypeError):
            mlp.fused_ln_mlp(x.float(), *mlp_args[:2], w1, torch.zeros(3000), w2, mlp_args[7])
    assert getattr(attention if kernel != "fused_ln_mlp" else mlp, kernel).launches == before


def test_bf16_linear_runs_cublas_with_one_rounding(device):
    """The plain bf16 ``linear`` on the card: bf16 operands, fp32 sums and
    output from cuBLAS, one rounding after the fp32 bias add."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 50, 256)).astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32) * 0.06).to(device)
    b = torch.from_numpy(rng.standard_normal(384).astype(np.float32)).to(device)
    y = clip._mm(x, w.to(torch.bfloat16))
    assert y.dtype == torch.float32 and y.shape == (3, 50, 384)
    ref = x.float() @ w.to(torch.bfloat16).float()  # exact products, TF32 off
    assert float((y - ref).abs().max()) <= 1e-4
    _agree(clip.linear(x, w, b), (ref + b).to(torch.bfloat16))


def _text_block_inputs(device, bsz, dtype, width=512, heads=8, rank=16, seed=5):
    """B/16 text-block weights (S=77, W=512, M=2048, H=8), LoRA of rank 16
    with nonzero B, x and an output cotangent."""
    rng = np.random.default_rng(seed)
    mlp_dim = 4 * width

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(device)

    bp = {"ln1": {"scale": 1 + t(width, std=0.1), "bias": t(width, std=0.1)},
          "ln2": {"scale": 1 + t(width, std=0.1), "bias": t(width, std=0.1)},
          "attn": {"wqkv": t(width, 3 * width, std=width ** -0.5), "bqkv": t(3 * width, std=0.1),
                   "wo": t(width, width, std=width ** -0.5), "bo": t(width, std=0.1)},
          "mlp": {"w1": t(width, mlp_dim, std=width ** -0.5), "b1": t(mlp_dim, std=0.1),
                  "w2": t(mlp_dim, width, std=mlp_dim ** -0.5), "b2": t(width, std=0.1)}}
    dims = {"out_proj": (width, width), "c_fc": (width, mlp_dim), "c_proj": (mlp_dim, width)}
    lora = {p: {"A": t(dims[p][0], rank, std=0.02), "B": t(rank, dims[p][1], std=0.02)}
            for p in dims}
    x = t(bsz, 77, width).to(dtype)
    dy = t(bsz, 77, width, std=0.01).to(dtype)
    return x, dy, bp, lora


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bsz", [1, 3])
def test_text_block_kernels_match_plain(device, dtype, bsz):
    x, dy, bp, lora = _text_block_inputs(device, bsz, dtype)
    mask = causal_mask(77, device=device)
    kw = dict(heads=8, scaling=2.0)
    before = (block_grad.text_block_fwd.launches, block_grad.text_block_bwd.launches)
    y = block_grad.text_block_fwd(x, mask, bp, lora, **kw)
    dx, dl = block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)
    torch.cuda.synchronize()
    assert (block_grad.text_block_fwd.launches, block_grad.text_block_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    y_ref = block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw)
    dx_ref, dl_ref = block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, **kw)
    assert y.dtype == dx.dtype == dtype
    for out, ref in ((y, y_ref), (dx, dx_ref)):
        _f32_agree(out, ref) if dtype == torch.float32 else _agree_rows(out, ref)
    for p in dl:
        for ab in "AB":
            got, want = dl[p][ab], dl_ref[p][ab]
            assert got.dtype == want.dtype == torch.float32
            if dtype == torch.float32:
                assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), (p, ab)
            else:
                cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
                assert float(cos) >= 0.9999, (p, ab)


def test_text_block_kernels_refuse_what_they_do_not_take(device):
    """Head dim other than 64, W or M not a multiple of 128, fp16, a mask
    that is not (S, S): each raises, and nothing launches."""
    kw = dict(heads=8, scaling=2.0)
    before = (block_grad.text_block_fwd.launches, block_grad.text_block_bwd.launches)
    x, dy, bp, lora = _text_block_inputs(device, 1, torch.float32)
    mask = causal_mask(77, device=device)
    with pytest.raises(ValueError):  # head dim 32
        block_grad.text_block_fwd(x, mask, bp, lora, heads=16, scaling=2.0)
    with pytest.raises(TypeError):
        block_grad.text_block_fwd(x.half(), mask, bp, lora, **kw)
    with pytest.raises(ValueError):
        block_grad.text_block_bwd(x, dy, mask[:76, :76], bp, lora, **kw)
    x5, dy5, bp5, lora5 = _text_block_inputs(device, 1, torch.float32, width=320, heads=5)
    with pytest.raises(ValueError):  # W = 320: head dim 64, W % 128 != 0
        block_grad.text_block_bwd(x5, dy5, mask, bp5, lora5, heads=5, scaling=2.0)
    assert (block_grad.text_block_fwd.launches, block_grad.text_block_bwd.launches) == before


def _int8_block_inputs(device, bsz, width=512, heads=8):
    x, dy, bp, lora = _text_block_inputs(device, bsz, torch.bfloat16, width=width, heads=heads)
    qw = {}
    for key, scale, (grp, name) in (("wqkv_q", "sqkv", ("attn", "wqkv")),
                                    ("w1_q", "s1", ("mlp", "w1")), ("w2_q", "s2", ("mlp", "w2"))):
        qw[key], qw[scale] = quant.quantize_weight(bp[grp][name])
    return x, dy, bp, qw, lora


@pytest.mark.parametrize("shape", [(1, 512, 8, None), (3, 512, 8, None), (3, 768, 12, (1, 6))],
                         ids=["B1", "B3", "B3_L14_chunked"])
def test_text_block_int8_kernels_match_plain(device, shape):
    """The int8 pair against its plain versions (bars of chip_smoke.py): y
    per row within 2 bf16 ULPs of the row's largest value and row cosine >=
    0.9999; dx row cosine >= 0.9999 (an int8 value rounding the other way
    moves a whole row of a cotangent product); each LoRA cotangent cosine
    >= 0.9999."""
    bsz, width, heads, plan = shape
    x, dy, bp, qw, lora = _int8_block_inputs(device, bsz, width, heads)
    mask = causal_mask(77, device=device)
    kw = dict(heads=heads, scaling=2.0)
    before = (block_grad.text_block_fwd_int8.launches, block_grad.text_block_bwd_int8.launches)
    y = block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, force_plan=plan, **kw)
    dx, dl = block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, force_plan=plan, **kw)
    torch.cuda.synchronize()
    assert (block_grad.text_block_fwd_int8.launches,
            block_grad.text_block_bwd_int8.launches) == (before[0] + 1, before[1] + 1)
    n_chunks = 1 if plan is None else plan[1]
    y_ref = block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, n_chunks=n_chunks, **kw)
    dx_ref, dl_ref = block_grad.text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora,
                                                        n_chunks=n_chunks, **kw)
    assert y.dtype == dx.dtype == torch.bfloat16
    _agree_rows(y, y_ref)
    cos = torch.nn.functional.cosine_similarity(dx.float().flatten(0, -2),
                                                dx_ref.float().flatten(0, -2), dim=-1)
    assert float(cos.min()) >= 0.9999
    for p in dl:
        for ab in "AB":
            got, want = dl[p][ab], dl_ref[p][ab]
            assert got.dtype == want.dtype == torch.float32
            cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
            assert float(cos) >= 0.9999, (p, ab)


@pytest.mark.parametrize("ksplit", [0, 512], ids=["whole", "split6"])
def test_int8_transposed_gemm_is_exact_at_an_odd_row_count(device, ksplit):
    """The int8 A @ B^T of the backward (WMMA signed char, col_major B tile),
    77 rows, against the exact product; with a split depth, each split's
    int32 partial."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 128, (77, 3072), dtype=torch.int8, device=device, generator=gen)
    b = torch.randint(-127, 128, (768, 3072), dtype=torch.int8, device=device, generator=gen)
    got = block_grad.int8_matmul_t_cuda(a, b, ksplit)
    step = ksplit or 3072
    want = torch.stack([(a[:, i:i + step].double() @ b[:, i:i + step].double().t()).int()
                        for i in range(0, 3072, step)])
    assert torch.equal(got, want)


def test_text_block_int8_kernels_refuse_what_they_do_not_take(device):
    """A non-bf16 x, an int8 weight of the wrong shape, head dim 32: each
    raises, and nothing launches."""
    x, dy, bp, qw, lora = _int8_block_inputs(device, 1)
    mask = causal_mask(77, device=device)
    kw = dict(heads=8, scaling=2.0)
    before = (block_grad.text_block_fwd_int8.launches, block_grad.text_block_bwd_int8.launches)
    with pytest.raises(TypeError):
        block_grad.text_block_fwd_int8(x.float(), mask, bp, qw, lora, **kw)
    with pytest.raises(ValueError):  # c_fc's int8 weight transposed
        block_grad.text_block_bwd_int8(x, dy, mask, bp, dict(qw, w1_q=qw["w1_q"].t()), lora, **kw)
    with pytest.raises(ValueError):  # head dim 32
        block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, heads=16, scaling=2.0)
    assert (block_grad.text_block_fwd_int8.launches,
            block_grad.text_block_bwd_int8.launches) == before


# ---------------------------------------------------------------------------
# The zoo's kernels: rows 3 (chunked int8 MLP), 4 (whole int8 block), 8
# (head-grouped core), and the large-S routes around them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 257, 2), (2, 257, 4), (1, 577, 4)],
                         ids=["L14_B1_C2", "L14_B2_C4", "L14_336_B1_C4"])
def test_int8_mlp_chunked_kernel_matches_plain(device, shape):
    """int8_ln_mlp at the ViT-L/14 widths takes the chunked kernel with the
    JAX planner's chunk count (C=2 at one image, 4 at an even batch)."""
    bsz, seq, n_chunks = shape
    x, _, mlp_w = _inputs(device, bsz, seq, 1024)
    assert quant._mlp_plan(bsz, seq, 1024, 4096, 2) == ("chunked", min(bsz, 2) if seq == 257
                                                        else 1, n_chunks)
    before = (quant.int8_ln_mlp.launches, quant.int8_ln_mlp_chunked.launches)
    out = quant.int8_ln_mlp(x, *mlp_w)
    torch.cuda.synchronize()
    assert (quant.int8_ln_mlp.launches, quant.int8_ln_mlp_chunked.launches) == (
        before[0], before[1] + 1)
    _agree(out, quant.int8_ln_mlp_ref(x, *mlp_w, n_chunks=n_chunks))


@pytest.mark.parametrize("case", [(2, 50, 768, 12, False, None), (4, 77, 512, 8, True, None),
                                  (2, 197, 768, 12, False, ("chunked", 2, 4)),
                                  (1, 257, 1024, 16, False, ("chunked", 1, 16))],
                         ids=["B32_full", "text_full_causal", "B16_chunked", "L14_chunked"])
def test_int8_block_kernel_matches_plain(device, case):
    bsz, seq, width, heads, masked, override = case
    x, attn, mlp_w = _inputs(device, bsz, seq, width)
    mask = causal_mask(seq, device=device) if masked else None
    plan = override or quant._block_plan(bsz, seq, width, 4 * width, 2)
    before = quant.int8_block.launches
    out = quant.int8_block(x, *attn, mask, *mlp_w, heads=heads, plan_override=override)
    torch.cuda.synchronize()
    assert quant.int8_block.launches == before + 1
    _agree(out, quant.int8_block_ref(x, *attn, mask, *mlp_w, heads=heads, plan=plan))


@pytest.mark.parametrize("bsz,seq,kind", [
    (b, s, False) for s in (1, 13, 63, 64, 65, 197, 257, 577) for b in (1, 3)] + [
    (2, 577, False), (3, 77, True), (2, 577, "dead_row"), (2, 577, "clamp")])
def test_headgroups_kernel_matches_plain_and_row7(device, bsz, seq, kind):
    """Row 8 at the ViT-L/14@336 width (W=1024, H=16) at hg = 1, 8 and 16
    against its plain version, at the tensor-core core's tile edges; every
    head group gives the same output bit for bit, and hg=16 is the packed
    core (row 7) on the packed layout of the same q, k, v."""
    qkv, mask, dead = _core_qkv(device, bsz, seq, 1024, 16, kind, torch.bfloat16, seed=7)
    hm = qkv[..., torch.from_numpy(attention.headmajor_perm(1024, 16)).long().to(device)]
    hm = hm.contiguous()
    ref = attention.fused_attention_qkv_headgroups_ref(hm, mask, 16)
    before = attention.fused_attention_qkv_headgroups.launches
    outs = {hg: attention.fused_attention_qkv_headgroups(hm, mask, heads=16, head_group=hg)
            for hg in (1, 8, 16)}
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv_headgroups.launches == before + 3
    _core_agree(outs[8], ref, dead)
    assert torch.equal(outs[1], outs[8]) and torch.equal(outs[16], outs[8])
    assert torch.equal(outs[16], attention._fused_attention_qkv_cuda(qkv, mask, 16))
    with pytest.raises(TypeError):  # fp32 has no tensor-core path that holds its 1e-5 bar
        attention.fused_attention_qkv_headgroups(hm.float(), heads=16, head_group=8)


def test_large_s_routes_match_plain_on_the_card(device):
    """ViT-L/14@336's attention halves: the int8 one (int8 projection, row 8
    on weights permuted head-major once) and the bf16 one (cuBLAS
    projections around row 8) against their plain versions; fp32's packed
    core overflows to the chunked reference on the card, no launch."""
    x, attn, _ = _inputs(device, 1, 577, 1024)
    before = attention.fused_attention_qkv_headgroups.launches
    out = quant.int8_ln_qkv_attention(x, *attn, heads=16)
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv_headgroups.launches == before + 1
    _agree(out, quant.int8_ln_qkv_attention_ref(x, *attn, heads=16))
    rng = np.random.default_rng(8)
    wqkv = torch.from_numpy(rng.standard_normal((1024, 3072)).astype(np.float32) / 32).to(device)
    args = (attn[0], attn[1], wqkv, attn[4], attn[5], attn[6])
    out = attention.fused_ln_qkv_attention(x, *args, heads=16)
    assert attention.fused_attention_qkv_headgroups.launches == before + 2
    _agree(out, attention.fused_ln_qkv_attention_ref(x, *args, heads=16))
    qkv = torch.from_numpy(rng.standard_normal((2, 577, 3072)).astype(np.float32)).to(device)
    launches = attention.fused_attention_qkv.launches
    out = attention.fused_attention_qkv(qkv, heads=16)
    assert attention.fused_attention_qkv.launches == launches
    _f32_agree(out, attention.attention_qkv_ref(qkv, None, 16))


def _randn(device, *shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 197, 12, 64, False), (3, 77, 8, 64, True),
                                   (2, 16, 4, 8, True)], ids=["vit", "text_causal", "tiny"])
def test_fused_attention_kernel_matches_plain(device, shape, dtype):
    bsz, seq, heads, dim, masked = shape
    q, k, v = (_randn(device, bsz, seq, heads, dim, dtype=dtype, seed=s) for s in (1, 2, 3))
    mask = causal_mask(seq, device=device) if masked else None
    before = attention.fused_attention.launches
    out = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1 and out.shape == q.shape
    ref = attention.fused_attention_ref(q, k, v, mask)
    _f32_agree(out, ref) if dtype == torch.float32 else _agree(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 77, 8, True), (2, 197, 12, False)],
                         ids=["text_causal_one_tile", "vit_streaming"])
def test_attention_qkv_bwd_kernel_matches_plain(device, shape, dtype):
    """Row 9 against its plain version: fp32 on the register-tiled passes,
    its scalar forms (one tile at S=77, streaming) beside, which repeat each
    other bit for bit; bf16 on the tensor-core passes at both shapes, held
    to the old bf16 one-tile form at S=77 at the bf16 bar."""
    bsz, seq, heads, masked = shape
    qkv = _randn(device, bsz, seq, 3 * 64 * heads, dtype=dtype, seed=4)
    g = _randn(device, bsz, seq, 64 * heads, dtype=dtype, seed=5)
    mask = causal_mask(seq, device=device) if masked else None
    before = attention.fused_attention_qkv_bwd.launches
    out = attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv_bwd.launches == before + 1
    ref = attention.fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads)
    _f32_agree(out, ref) if dtype == torch.float32 else _agree(out, ref)
    if dtype == torch.float32:
        streamed = attention._fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, "streaming")
        _f32_agree(streamed, ref)
        if seq <= 128:  # the streaming form repeats the one-tile kernel
            assert torch.equal(streamed, attention._fused_attention_qkv_bwd_cuda(
                qkv, mask, g, heads, "one_tile"))
    elif seq <= 128:
        _agree(out, attention._fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, "one_tile"))


def _cuda_kernels(fn) -> set:
    """Names of the CUDA kernels that fn() launches, from the profiler. The
    first profiler trace of a process has come back with no kernel at all on
    the card (for a route that passes alone), so an empty trace is taken once
    more: a call that launches nothing gives an empty set both times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return names


def _launched(names: set, needle: str) -> bool:
    return any(needle in n for n in names)


def _bwd_agree_rows(out, ref, dead, width):
    """Row 9's bf16 edge bar: per row of the cotangent (chip_smoke.py's
    ``_bwd_edge_agreement``) on the rows whose plain value is not all zero,
    those rows zero in the kernel too, and dq of a removed row zero."""
    zero = (ref == 0).all(dim=-1).all(dim=0)
    assert bool((out[:, zero] == 0).all())
    _agree_rows(out[:, ~zero], ref[:, ~zero])
    if dead:
        assert bool((out[:, dead, :width] == 0).all()) and bool((ref[:, dead, :width] == 0).all())


# (B, S, mask kind) at the tile edges of the bf16 tensor-core forms of rows 9
# and 6; W, H from S as chip_smoke.py's EDGE_WIDTHS.
BWD_EDGES = ([(b, s, False) for s in (1, 13, 63, 64, 65, 128, 129, 197, 257) for b in (1, 3)]
             + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 130, "dead_row"),
                (2, 197, "clamp")])
ROW6_EDGES = ([(b, s, False) for s in (1, 63, 65, 197) for b in (1, 3)]
              + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 197, "clamp")])
EDGE_WIDTHS = {77: (512, 8), 197: (768, 12)}


@pytest.mark.parametrize("bsz,seq,kind", BWD_EDGES)
def test_attention_qkv_bwd_tensor_core_edges(device, bsz, seq, kind):
    """bf16 row 9 on the tensor-core passes at their tile edges, one counted
    launch, against its plain version; a run repeats bit for bit."""
    width, heads = EDGE_WIDTHS.get(seq, (256, 4))
    qkv, mask, dead = _core_qkv(device, bsz, seq, width, heads, kind, torch.bfloat16, seed=9)
    g = _randn(device, bsz, seq, width, dtype=torch.bfloat16, seed=10)
    before = attention.fused_attention_qkv_bwd.launches
    out = attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv_bwd.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    _bwd_agree_rows(out, attention.fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads), dead,
                    width)
    assert torch.equal(attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads), out)


# fp32 row 9's register-tiled form at its edges (chip_smoke.py's
# BWD_F32_EDGE_CASES): the bf16 ones and a tile of 31, 32 and 33 rows.
BWD_F32_EDGES = ([(b, s, False) for s in (1, 13, 31, 32, 33, 63, 64, 65, 128, 129, 197, 257)
                  for b in (1, 3)]
                 + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 130, "dead_row"),
                    (2, 197, "clamp")])


@pytest.mark.parametrize("bsz,seq,kind", BWD_F32_EDGES)
def test_attention_qkv_bwd_register_tiled_edges(device, bsz, seq, kind):
    """fp32 row 9 on the register-tiled passes at their tile edges, one
    counted launch, against its plain version at the fp32 bar on the rows
    whose plain cotangent is not all zero (those zero in the kernel too, and
    dq of a removed row zero); a run repeats bit for bit."""
    width, heads = EDGE_WIDTHS.get(seq, (256, 4))
    qkv, mask, dead = _core_qkv(device, bsz, seq, width, heads, kind, torch.float32, seed=15)
    g = _randn(device, bsz, seq, width, seed=16)
    before = attention.fused_attention_qkv_bwd.launches
    out = attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_qkv_bwd.launches == before + 1
    ref = attention.fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads)
    zero = (ref == 0).all(dim=-1).all(dim=0)
    assert bool((out[:, zero] == 0).all())
    _f32_agree(out[:, ~zero], ref[:, ~zero])
    if dead:
        assert bool((out[:, dead, :width] == 0).all())
    assert torch.equal(attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads), out)


@pytest.mark.parametrize("bsz,seq,kind", ROW6_EDGES)
def test_fused_attention_tensor_core_edges(device, bsz, seq, kind):
    """bf16 row 6 at D=64 on the tensor-core core of rows 7-8 (separate q, k,
    v) at its tile edges, one counted launch, against its plain version and
    bit for bit row 7's kernel on the packed projection of the same q, k, v."""
    width, heads = EDGE_WIDTHS.get(seq, (256, 4))
    qkv, mask, dead = _core_qkv(device, bsz, seq, width, heads, kind, torch.bfloat16, seed=11)
    q, k, v = (t.reshape(bsz, seq, heads, 64).contiguous() for t in qkv.split(width, -1))
    before = attention.fused_attention.launches
    out = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1 and out.shape == q.shape
    ref = attention.fused_attention_ref(q, k, v, mask)
    _core_agree(out.reshape(bsz, seq, width), ref.reshape(bsz, seq, width), dead)
    assert torch.equal(out.reshape(bsz, seq, width),
                       attention._fused_attention_qkv_cuda(qkv, mask, heads))


# fp32 rows 7 and 6 (D=64) on the register-tiled core at its edges, fp32 row
# 9's (the same 64-row tiles and 16-row groups; chip_smoke.py's
# FWD_F32_EDGE_CASES).
@pytest.mark.parametrize("bsz,seq,kind", BWD_F32_EDGES)
def test_f32_core_edges(device, bsz, seq, kind):
    """fp32 row 7 and row 6 on the register-tiled core at its tile edges, one
    counted launch each, at the fp32 bar on the rows the mask leaves keys in
    (rows it removes whole zero); row 6 bit for bit row 7 on the same q, k,
    v, a run repeats bit for bit, and the scalar form it replaced holds the
    same bar where K and V fit its shared memory."""
    width, heads = EDGE_WIDTHS.get(seq, (256, 4))
    qkv, mask, dead = _core_qkv(device, bsz, seq, width, heads, kind, torch.float32, seed=21)
    ref = attention.fused_attention_qkv_ref(qkv, mask, heads)
    before = (attention.fused_attention_qkv.launches, attention.fused_attention.launches)
    out = attention.fused_attention_qkv(qkv, mask, heads=heads)
    q, k, v = (t.reshape(bsz, seq, heads, 64).contiguous() for t in qkv.split(width, -1))
    out6 = attention.flash_attention(q, k, v, mask).reshape(bsz, seq, width)
    torch.cuda.synchronize()
    assert (attention.fused_attention_qkv.launches,
            attention.fused_attention.launches) == (before[0] + 1, before[1] + 1)
    _core_agree(out, ref, dead)
    assert torch.equal(out6, out)
    assert torch.equal(attention.fused_attention_qkv(qkv, mask, heads=heads), out)
    if seq <= 454:
        _core_agree(attention._fused_attention_qkv_cuda(qkv, mask, heads, "scalar"), ref, dead)


def test_attention_core_op_routes(device):
    """Which kernels each route of rows 6, 7 and 9 launches: bf16 D=64 row 6
    the tensor-core core, fp32 D=64 rows 6 and 7 the register-tiled core (the
    scalar one only as row 7's private scalar form), D=8 the scalar core;
    bf16 row 9 the two
    tensor-core passes at every S, fp32 the two register-tiled passes at
    every S (not the one-tile kernel at S=77, not the scalar streaming
    passes at S=197)."""
    mask = causal_mask(77, device=device)
    for dtype, dim, want, not_want in ((torch.bfloat16, 64, "attn_core_mma_kernel", "attn_core_kernel"),
                                       (torch.float32, 64, "attn_core_f32_kernel", "attn_core_kernel<"),
                                       (torch.float32, 8, "attn_core_kernel<float, 8", "f32"),
                                       (torch.bfloat16, 8, "attn_core_kernel<__nv_bfloat16, 8", "mma")):
        q = _randn(device, 2, 77, 4, dim, dtype=dtype, seed=12)
        names = _cuda_kernels(lambda: attention.flash_attention(q, q, q, mask))
        assert _launched(names, want) and not _launched(names, not_want), (dtype, dim, names)
    qkv = _randn(device, 2, 77, 3 * 256, seed=20)
    names = _cuda_kernels(lambda: attention.fused_attention_qkv(qkv, mask, heads=4))
    assert _launched(names, "attn_core_f32_kernel") and not _launched(names, "attn_core_kernel<")
    names = _cuda_kernels(lambda: attention._fused_attention_qkv_cuda(qkv, mask, 4, "scalar"))
    assert _launched(names, "attn_core_kernel<float, 64") and not _launched(names, "f32"), names
    for dtype, seq, want, not_want in ((torch.bfloat16, 77, "core_bwd_mma_query_kernel", "block_core"),
                                       (torch.bfloat16, 197, "core_bwd_mma_key_kernel", "core_bwd_query"),
                                       (torch.float32, 77, "core_bwd_tiled_query_kernel", "block_core"),
                                       (torch.float32, 197, "core_bwd_tiled_key_kernel", "core_bwd_key_kernel<float")):
        qkv = _randn(device, 2, seq, 3 * 256, dtype=dtype, seed=13)
        g = _randn(device, 2, seq, 256, dtype=dtype, seed=14)
        m = mask if seq == 77 else None
        names = _cuda_kernels(lambda: attention.fused_attention_qkv_bwd(qkv, m, g, heads=4))
        assert _launched(names, want) and not _launched(names, not_want), (dtype, seq, names)


def _wmma_gemm(names: set) -> bool:
    """Whether common.cuh's WMMA gemm_kernel is among the launched kernels
    (not the text block's SIMT simt_gemm_kernel or sgemm_kernel)."""
    return any(re.search(r"(?<![A-Za-z_])gemm_kernel<", n) for n in names)


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_text_block_backwards_keep_their_core(device, path):
    """Rows 12 and 14 (text_block_bwd, text_block_bwd_int8) run form 0:
    their backbone products on the wgmma stage (wgmma_stage_kernel), their
    core backward on row 9's tensor-core passes (core_bwd_mma_*), the
    recomputed core forward on the tensor-core kernel
    (block_core_fwd_mma_kernel) and the rank-r products on rank_down_kernel
    and rank_cot_kernel; no WMMA gemm_kernel, block_core_bwd_kernel,
    block_core_fwd_kernel or SIMT simt_gemm_kernel (which form 1 keeps); and
    they repeat themselves bit for bit across two calls. (Before the
    redesign this test pinned block_core_bwd_kernel, the core they then
    ran.)"""
    mask = causal_mask(77, device=device)
    kw = dict(heads=8, scaling=2.0)
    if path == "bf16":
        x, dy, bp, lora = _text_block_inputs(device, 3, torch.bfloat16)
        call = lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)  # noqa: E731
    else:
        x, dy, bp, qw, lora = _int8_block_inputs(device, 3)
        call = lambda: block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw)  # noqa: E731
    first = call()
    names = _cuda_kernels(call)
    assert _launched(names, "wgmma_stage_kernel") and _launched(names, "core_bwd_mma_query")
    assert _launched(names, "core_bwd_mma_key")
    assert not _wmma_gemm(names) and not _launched(names, "block_core_bwd_kernel"), names
    # the recomputed forward's core and the rank-r products
    assert _launched(names, "block_core_fwd_mma_kernel") and _launched(names, "rank_down_kernel")
    assert _launched(names, "rank_cot_kernel")
    assert not _launched(names, "block_core_fwd_kernel<"), names
    assert not _launched(names, "simt_gemm"), names
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for p in first[1]:
        for ab in "AB":
            assert torch.equal(first[1][p][ab], second[1][p][ab])


def _block_agree(got, want, int8: bool):
    """The text-block bars: dx every row within 2 bf16 ULPs of its largest
    value and row cosine >= 0.9999 (int8: the row cosine alone), each LoRA
    cotangent cosine >= 0.9999."""
    dx, dl = got
    if int8:
        cos = torch.nn.functional.cosine_similarity(dx.float().flatten(0, -2),
                                                    want[0].float().flatten(0, -2), dim=-1)
        assert float(cos.min()) >= 0.9999
    else:
        _agree_rows(dx, want[0])
    for p in dl:
        for ab in "AB":
            cos = torch.nn.functional.cosine_similarity(dl[p][ab].flatten(),
                                                        want[1][p][ab].flatten(), dim=0)
            assert float(cos) >= 0.9999, (p, ab)


# (B, W, H, int8 plan) of the form checks: B = 1, 3 at the B/16 text width,
# and the L/14 text width on the chunked int8 plan (C = 6).
FORM_CASES = [(1, 512, 8, None), (3, 512, 8, None), (3, 768, 12, (1, 6))]
FORM_IDS = ["B1", "B3", "B3_W768"]


@pytest.mark.parametrize("path", ["bf16", "int8"])
@pytest.mark.parametrize("case", FORM_CASES, ids=FORM_IDS)
def test_text_block_forms_match_plain_and_each_other(device, path, case):
    """Rows 11-14 in form 0 (the route) and form 1 (the first design,
    uncounted): each against the plain version and form 0 against form 1
    at the text-block bars, form 0 repeating itself bit for bit, form 1
    launching the WMMA gemm_kernel, block_core_bwd_kernel,
    block_core_fwd_kernel and simt_gemm_kernel and no stage. The int8
    forward's two forms are not bit for bit: their int32 products are, but
    form 0's core forward sums fp32 on the tensor cores in another order
    (test_block_core_fwd_mma_matches_scalar_core holds that core alone)."""
    bsz, width, heads, plan = case
    mask = causal_mask(77, device=device)
    a = (heads, 2.0, 1e-5)
    if path == "bf16":
        x, dy, bp, lora = _text_block_inputs(device, bsz, torch.bfloat16, width, heads)
        fwd = lambda form: block_grad._text_block_fwd_cuda(x, mask, bp, lora, *a, form)  # noqa: E731
        bwd = lambda form: block_grad._text_block_bwd_cuda(x, dy, mask, bp, lora, *a,  # noqa: E731
                                                           form)
        y_ref = block_grad.text_block_fwd_ref(x, mask, bp, lora, heads=heads, scaling=2.0)
        ref = block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, heads=heads, scaling=2.0)
    else:
        x, dy, bp, qw, lora = _int8_block_inputs(device, bsz, width, heads)
        c = block_grad._int8_chunks(x, 4 * width, heads, plan)
        fwd = lambda form: block_grad._text_block_fwd_int8_cuda(  # noqa: E731
            x, mask, bp, qw, lora, *a, form)
        bwd = lambda form: block_grad._text_block_bwd_int8_cuda(  # noqa: E731
            x, dy, mask, bp, qw, lora, *a, c, form)
        y_ref = block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, heads=heads,
                                                   scaling=2.0, n_chunks=c)
        ref = block_grad.text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora, heads=heads,
                                                 scaling=2.0, n_chunks=c)
    before = _build.launch_counts()
    y0, y1 = fwd("wgmma"), fwd("wmma")
    g0, g1 = bwd("wgmma"), bwd("wmma")
    torch.cuda.synchronize()
    assert _build.launch_counts() == before  # the private forms count nothing
    for y in (y0, y1):
        _agree_rows(y, y_ref)
    _agree_rows(y0, y1)
    assert torch.equal(y0, fwd("wgmma"))
    for g in (g0, g1):
        _block_agree(g, ref, path == "int8")
    _block_agree(g0, g1, path == "int8")
    names = _cuda_kernels(lambda: bwd("wmma"))
    assert _wmma_gemm(names) and _launched(names, "block_core_bwd_kernel")
    assert _launched(names, "block_core_fwd_kernel<") and _launched(names, "simt_gemm_kernel")
    assert not _launched(names, "wgmma_stage_kernel") and not _launched(names, "core_bwd_mma")
    assert not _launched(names, "rank_") and not _launched(names, "block_core_fwd_mma")


@pytest.mark.parametrize("bsz", [1, 3])
def test_fp32_text_block_keeps_its_route(device, bsz):
    """fp32 rows 11 and 12 take form 0 alone, their SIMT route: the 128 x
    128 tile (sgemm_kernel), the rank-r kernels
    (rank_down_kernel, rank_cot_kernel), the register-tiled core forward
    of rows 6-7 (attn_core_f32_kernel) and row 9's register-tiled core
    backward (core_bwd_tiled_*), no block_core_bwd_kernel, no wgmma stage,
    no WMMA GEMM, no tensor-core core; a second run bit for bit the first,
    and "wmma" refused."""
    x, dy, bp, lora = _text_block_inputs(device, bsz, torch.float32)
    mask = causal_mask(77, device=device)
    kw = dict(heads=8, scaling=2.0)
    fwd = lambda: block_grad.text_block_fwd(x, mask, bp, lora, **kw)  # noqa: E731
    bwd = lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)  # noqa: E731
    for call in (fwd, bwd):
        names = _cuda_kernels(call)
        assert _launched(names, "sgemm_kernel") and not _wmma_gemm(names), names
        assert _launched(names, "rank_down_kernel") and _launched(names, "attn_core_f32_kernel")
        assert not _launched(names, "wgmma_stage_kernel") and not _launched(names, "core_bwd_mma")
        assert not _launched(names, "block_core_") and not _launched(names, "simt_gemm"), names
    names = _cuda_kernels(bwd)
    assert _launched(names, "core_bwd_tiled_query") and _launched(names, "core_bwd_tiled_key")
    assert _launched(names, "rank_cot_kernel")
    y, (dx, dl) = fwd(), bwd()
    assert torch.equal(y, fwd())
    dx2, dl2 = bwd()
    assert torch.equal(dx, dx2)
    assert all(torch.equal(dl[p][ab], dl2[p][ab]) for p in dl for ab in "AB")
    with pytest.raises(ValueError):
        block_grad._text_block_bwd_cuda(x, dy, mask, bp, lora, 8, 2.0, 1e-5, "wmma")


# (kind, rows, depth or wide side K, rank, trans): every launch shape of
# rows 11-14 at B = 1 and 7 (77 and 539 rows; 256 text rows in phase 9),
# depth W and M, and a rank of two column groups.
RANK_CASES = [(kind, rows, k, 16, trans) for kind in ("down", "cotangent") for rows in (77, 539)
              for k in (512, 2048) for trans in (False, True)] + [
    ("down", 539, 512, 20, False), ("cotangent", 539, 512, 20, True), ("down", 77, 768, 4, True)]


@pytest.mark.parametrize("a_dtype", ["fp32", "bf16", "bf16_a_fp32"])
@pytest.mark.parametrize("case", RANK_CASES,
                         ids=[f"{c[0]}_{c[1]}_{c[2]}_r{c[3]}{'_t' if c[4] else ''}"
                              for c in RANK_CASES])
def test_rank_product_kernel_is_narrow_gemm(device, a_dtype, case):
    """The rank-r kernels of form 0 (rank_down_kernel, rank_cot_kernel) bit
    for bit form 1's narrow_gemm (the same fmaf chains over each chunk in
    order, the partials added in chunk order) at the text block's launch
    shapes, in fp32 and bf16 (a in fp32 rounded on load, as u, dfq and dy1
    are), and within fp32 rounding of the plain version."""
    kind, rows, k, rank, trans = case
    gen = torch.Generator(device=device).manual_seed(rows + k + rank)
    dtype = torch.float32 if a_dtype == "fp32" else torch.bfloat16
    a = torch.randn((rows, k), generator=gen, device=device)
    a = a if a_dtype != "bf16" else a.to(dtype)
    if kind == "down":
        b = torch.randn((rank, k) if trans else (k, rank), generator=gen, device=device).to(dtype)
    else:
        b = torch.randn((rows, rank), generator=gen, device=device).to(dtype)
    kw = dict(trans=trans, scaling=2.0)
    got = block_grad.rank_product_cuda(a, b, kind, **kw)
    assert torch.equal(got, block_grad.rank_product_cuda(a, b, kind, form="wmma", **kw))
    ref = block_grad.rank_product_ref(a, b, kind, dtype=dtype, **kw)
    if dtype == torch.float32 or kind == "cotangent":
        assert float((got.float() - ref.float()).abs().max() / ref.abs().max()) <= 1e-5
    else:
        _agree(got, ref)


@pytest.mark.parametrize("bsz", [1, 7, 64])
@pytest.mark.parametrize("masked", [True, False], ids=["causal", "nomask"])
def test_block_core_fwd_mma_matches_scalar_core(device, bsz, masked):
    """The tensor-core core forward of form 0 (block_core_fwd_mma_kernel,
    p normalized before p.V) against form 1's block_core_fwd_kernel and the
    plain version on the same qkv, at the bf16 bar, at S=77; S=80 (the
    tile's last key) against the plain version; S=81 refused."""
    gen = torch.Generator(device=device).manual_seed(bsz)
    mask = causal_mask(77, device=device) if masked else None
    qkv = torch.randn((bsz, 77, 1536), generator=gen, device=device).to(torch.bfloat16)
    got = block_grad.block_core_fwd_cuda(qkv, mask, 8)
    _agree(got, block_grad.block_core_fwd_cuda(qkv, mask, 8, form="wmma"))
    _agree(got, block_grad.block_core_fwd_ref(qkv, mask, 8))
    assert torch.equal(got, block_grad.block_core_fwd_cuda(qkv, mask, 8))
    q80 = torch.randn((bsz, 80, 1536), generator=gen, device=device).to(torch.bfloat16)
    _agree(block_grad.block_core_fwd_cuda(q80, None, 8),
           block_grad.block_core_fwd_ref(q80, None, 8))
    with pytest.raises(ValueError):
        block_grad.block_core_fwd_cuda(torch.zeros_like(q80[:, :1]).expand(bsz, 81, 1536), None, 8)


# Row 12 fp32's backbone products at B = 7 (539 rows): (K, N, w read as (N, K)).
SGEMM_CASES = [(512, 1536, False), (512, 512, False), (512, 2048, False), (2048, 512, False),
               (512, 2048, True), (2048, 512, True), (512, 512, True), (1536, 512, True)]


@pytest.mark.parametrize("case", SGEMM_CASES,
                         ids=[f"K{c[0]}_N{c[1]}{'_t' if c[2] else ''}" for c in SGEMM_CASES])
def test_text_sgemm_tile_matches_cublas(device, case):
    """fp32 rows 11-12's backbone tile alone (sgemm_kernel, the product that
    phase 9 times beside cuBLAS SGEMM) on each product shape, M ragged:
    within the fp32 bar of cuBLAS without TF32, and bit for bit a second
    run."""
    k, n, trans = case
    gen = torch.Generator(device=device).manual_seed(k + n)
    a = torch.randn((539, k), generator=gen, device=device)
    w = torch.randn((n, k) if trans else (k, n), generator=gen, device=device)
    got = block_grad.text_sgemm_cuda(a, w, trans=trans)
    assert torch.equal(got, block_grad.text_sgemm_cuda(a, w, trans=trans))
    attention.no_tf32()
    ref = a @ (w.t() if trans else w)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.parametrize("rows", [77, 539])
def test_int8_transposed_gemm_stage_form_is_the_wmma_form(device, rows):
    """The backward's int8 A @ B^T on the wgmma stage (B = the weight as it
    lies, K-major) bit for bit its WMMA form and the exact product."""
    gen = torch.Generator(device=device).manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 3072), dtype=torch.int8, device=device, generator=gen)
    b = torch.randint(-127, 128, (768, 3072), dtype=torch.int8, device=device, generator=gen)
    got = block_grad.int8_matmul_t_cuda(a, b, form="wgmma")
    assert torch.equal(got, block_grad.int8_matmul_t_cuda(a, b, form="wmma"))
    assert torch.equal(got[0], (a.double() @ b.double().t()).int())


@pytest.mark.parametrize("n_chunks", [1, 2, 6])
@pytest.mark.parametrize("rows", [1, 539])
def test_chunk_rowscale_is_the_split_product_and_its_sum(device, rows, n_chunks):
    """Row 14's chunked dh2 fold alone (``chunk_rowscale``, K = 3072, N =
    768: the L/14 text block's dfq . W1^T) bit for bit form 1's split WMMA
    product (``int8_matmul_t_cuda`` in K/C splits) plus its in-order sum
    from 0, and its plain version; one counted launch."""
    gen = torch.Generator(device=device).manual_seed(rows + n_chunks)
    k, n = 3072, 768
    a = torch.randint(-127, 128, (rows, k), dtype=torch.int8, device=device, generator=gen)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=device, generator=gen)
    rs = torch.rand(rows, n_chunks, device=device, generator=gen) / 100
    before = quant.gemm_stage.launches
    out = quant.gemm_stage(a, w, "chunk_rowscale", row_scale=rs, n_chunks=n_chunks)
    torch.cuda.synchronize()
    assert quant.gemm_stage.launches == before + 1
    parts = block_grad.int8_matmul_t_cuda(a, w.t().contiguous(), k // n_chunks, "wmma")
    total = torch.zeros_like(out)
    for c in range(n_chunks):
        total = total + parts[c].float() * rs[:, c:c + 1]
    assert torch.equal(out, total)
    assert torch.equal(out, quant.gemm_stage_ref(a, w, "chunk_rowscale", row_scale=rs,
                                                 n_chunks=n_chunks))


@pytest.mark.parametrize("shape", [(77, 512, 2048), (77, 2048, 512), (539, 1536, 512),
                                   (1, 512, 1536)], ids=["K512", "K2048", "K1536", "row1"])
def test_gemm_stage_bf16_kmajor_b(device, shape):
    """The stage's bf16 K-major B (``dot_t``: g . W^T with W (N, K) as it
    lies) at K = 512 and 2048 (the text block's dy.W2^T and dfq.W1^T) and
    the others of rows 12-14: within 1e-5 of the largest |entry| of its
    plain version (fp32 sums in another order), and against the WMMA form
    reading W transposed (measured equal on the card); one counted launch."""
    rows, k, n = shape
    a = _randn(device, rows, k, dtype=torch.bfloat16, seed=k)
    w = (_randn(device, n, k, seed=n) / 16).to(torch.bfloat16)
    before = quant.gemm_stage.launches
    out = quant.gemm_stage(a, w, "dot_t")
    torch.cuda.synchronize()
    assert quant.gemm_stage.launches == before + 1 and out.dtype == torch.float32
    ref = quant.gemm_stage_ref(a, w, "dot_t")
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    wmma = quant._gemm_stage_cuda(a, w, "dot_t", None, None, None, None, "wmma")
    assert float((out - wmma).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_attention_core_ops_refuse_what_they_do_not_take(device):
    before = (attention.fused_attention.launches, attention.fused_attention_qkv_bwd.launches)
    q = torch.zeros((1, 17, 2, 32), device=device)
    with pytest.raises(ValueError):  # head dim 32: built for 8 and 64
        attention.flash_attention(q, q, q)
    # fp32 at S=577, which the scalar core refused (K and V of a head exceed
    # shared memory), runs the register-tiled core: one launch at the fp32 bar
    q, k, v = (_randn(device, 1, 577, 16, 64, seed=s) for s in (17, 18, 19))
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before[0] + 1
    _f32_agree(out, attention.fused_attention_ref(q, k, v))
    before = (before[0] + 1, before[1])
    with pytest.raises(ValueError):  # the scalar form keeps its shared-memory limit
        attention._fused_attention_cuda(q, k, v, None, "scalar")
    with pytest.raises(ValueError):
        attention.flash_attention(q.half(), q.half(), q.half())
    qkv, g = torch.zeros((1, 17, 3 * 768), device=device), torch.zeros((1, 17, 768), device=device)
    with pytest.raises(ValueError):  # head dim 48
        attention.fused_attention_qkv_bwd(qkv, None, g, heads=16)
    qkv, g = torch.zeros((1, 129, 3 * 512), device=device), torch.zeros((1, 129, 512), device=device)
    with pytest.raises(ValueError):  # the one-tile kernel holds S <= 128
        attention._fused_attention_qkv_bwd_cuda(qkv, None, g, 8, "one_tile")
    with pytest.raises(ValueError):  # the tensor-core form takes bf16
        attention._fused_attention_qkv_bwd_cuda(qkv, None, g, 8, "mma")
    with pytest.raises(ValueError):  # the register-tiled form takes fp32
        attention._fused_attention_qkv_bwd_cuda(qkv.bfloat16(), None, g.bfloat16(), 8, "tiled")
    assert (attention.fused_attention.launches,
            attention.fused_attention_qkv_bwd.launches) == before


@pytest.mark.parametrize("body", ["mxu_bf16", "mxu_i8", "mxu_i8_quant"])
def test_mxu_probe_kernels_match_plain(device, body):
    x_bf, x_i8, w_bf, w_i8 = mxu_probe.inputs(device, steps=2)
    x, w = {"mxu_bf16": (x_bf, w_bf), "mxu_i8": (x_i8, w_i8), "mxu_i8_quant": (x_bf, w_i8)}[body]
    fn = getattr(mxu_probe, body)
    before = fn.launches
    out = fn(x, w, 3)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = getattr(mxu_probe, body + "_ref")(x, w, 3)
    if body == "mxu_i8":
        assert torch.equal(out, ref)
    else:
        _agree(out, ref)


def test_auto_int8_engine_launches_as_pallas(device):
    """``attn_impl="auto"`` gives the serving kernels on the card: the int8
    engine launches exactly what the ``"pallas"`` one does."""
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params

    params = init_clip_params(VIT_B_16, torch.Generator(device=device).manual_seed(0),
                              device=device)
    vocab = [{"image_path": "x.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
              "materials": ["drewno"], "colors": ["biały"], "room_type": "kuchnia"}]
    px = np.random.default_rng(9).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    counts = {}
    for impl in ("auto", "pallas"):
        _build.reset_launch_counts()
        engine = InteriorAnalyzer(params, VIT_B_16, training_data=vocab, device=device,
                                  dtype=torch.bfloat16, quantize=True, wire_format="patch",
                                  attn_impl=impl)
        engine.classify_pixels(px)
        counts[impl] = _build.launch_counts()
    assert counts["auto"] == counts["pallas"]
    assert counts["auto"]["int8_ln_qkv_attention"] > 0 and counts["auto"]["int8_ln_mlp"] > 0


@pytest.fixture(scope="module")
def variant_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    return kernel_experiments.model(torch.device("cuda", 0))[1][0]


VARIANT_CASES = [(w, v) for w, vs in variants.WRAPPER_VARIANTS.items() for v in vs]


def _variant_x(device, bsz, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((bsz, 197, 768), generator=gen, device=device)
    x[0, 0] = 0.0
    return x.to(torch.bfloat16)


def _variant_agree(out, ref, variant):
    if variant == "maconly":
        assert torch.equal(out, ref)
        return
    o, r = out.flatten(0, -2), ref.flatten(0, -2)
    zero = ~r.bool().any(dim=-1)
    assert torch.equal(o[zero], r[zero])
    _agree(o[~zero], r[~zero])


@pytest.mark.parametrize("bsz", [2, 64])
@pytest.mark.parametrize("wrapper,variant", VARIANT_CASES, ids=[f"{w}-{v}" for w, v in VARIANT_CASES])
def test_variant_kernels_match_plain(device, variant_layer, wrapper, variant, bsz):
    """Form 0 (the stage and the tensor-core variant core), one counted
    launch, against the plain version; the 16d schedules bit for bit row 1's
    form 0 and gelu2 row 2's."""
    x = _variant_x(device, bsz)
    fn = variants.WRAPPERS[wrapper]
    before = fn.launches
    out = fn(x, variant_layer, variant)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _variant_agree(out, variants.PLAIN[wrapper](x, variant_layer, variant), variant)
    lp = variant_layer
    if wrapper == "attn_var5":  # row 1's arithmetic without its 1e-38 guard
        row1 = quant._int8_ln_qkv_attention_cuda(x, lp["ln1_s"], lp["ln1_b"], lp["wqkv_q"],
                                                 lp["sqkv"], lp["bqkv"], lp["wo"], lp["bo"], None,
                                                 lp["heads"], 1e-5, "wgmma")
        assert torch.equal(out, row1)
    if variant == "gelu2":  # row 2's sequence
        row2 = quant._int8_ln_mlp_cuda(x, lp["ln2_s"], lp["ln2_b"], lp["w1_q"], lp["s1"],
                                       lp["b1"], lp["w2_q"], lp["s2"], lp["b2"], 1e-5)
        assert torch.equal(out, row2)


@pytest.mark.parametrize("wrapper,variant", VARIANT_CASES, ids=[f"{w}-{v}" for w, v in VARIANT_CASES])
def test_variant_wmma_form_matches_plain(device, variant_layer, wrapper, variant):
    """Form 1 (the first design, uncounted) still holds the plain version."""
    x = _variant_x(device, 2)
    kernel = variants._mlp_cuda if wrapper.startswith("mlp") else variants._attn_cuda
    before = variants.WRAPPERS[wrapper].launches
    out = kernel(wrapper, x, variant_layer, variant, form="wmma")
    torch.cuda.synchronize()
    assert variants.WRAPPERS[wrapper].launches == before
    _variant_agree(out, variants.PLAIN[wrapper](x, variant_layer, variant), variant)


def test_variant_kernels_refuse_what_they_do_not_take(device, variant_layer):
    x = torch.zeros((3, 197, 768), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="odd batch"):
        variants.attn_var2(x, variant_layer, "v4")
    with pytest.raises(TypeError, match="bf16"):
        variants.mlp_var(x.float(), variant_layer)


@pytest.mark.parametrize("form", mxu_probe.FORMS)
@pytest.mark.parametrize("inner", [3, 64])
@pytest.mark.parametrize("body", ["mxu_bf16", "mxu_i8", "mxu_i8_quant"])
def test_mxu_probe_forms_match_plain(device, body, inner, form):
    """Row 17's two forms on two row blocks: the wgmma form through the
    public wrapper (one counted launch), the WMMA form it replaced through
    the private route (none); int8 exact, the others at the bf16 bar."""
    x_bf, x_i8, w_bf, w_i8 = mxu_probe.inputs(device, steps=2)
    x, w = {"mxu_bf16": (x_bf, w_bf), "mxu_i8": (x_i8, w_i8), "mxu_i8_quant": (x_bf, w_i8)}[body]
    fn = getattr(mxu_probe, body)
    before = fn.launches
    out = fn(x, w, inner) if form == "wgmma" else mxu_probe._probe_cuda(body, x, w, inner, form)
    torch.cuda.synchronize()
    assert fn.launches == before + (form == "wgmma")
    ref = getattr(mxu_probe, body + "_ref")(x, w, inner)
    if body == "mxu_i8":
        assert torch.equal(out, ref)
    else:
        _agree(out, ref)


# Phase 3's cases of rows 1-2 (chip_smoke.py): images B = 1, 3, 8, text B=48
# causal, an all-zero LN row.
ROW12_CASES = [(1, 197, 768, 12, False, False), (3, 197, 768, 12, False, False),
               (8, 197, 768, 12, False, False), (48, 77, 512, 8, True, False),
               (2, 197, 768, 12, False, True)]
ROW12_IDS = ["image_B1", "image_B3", "image_B8", "text_B48_causal", "image_B2_zero_row"]


def _row12_inputs(device, bsz, seq, width, zero_row):
    x, attn, mlp_w = _inputs(device, bsz, seq, width, seed=bsz)
    if zero_row:  # an all-zero LN output row: the 1e-6 scale floor
        x[0, 0] = 0.0
        attn = (attn[0], torch.zeros_like(attn[1])) + attn[2:]
        mlp_w = (mlp_w[0], torch.zeros_like(mlp_w[1])) + mlp_w[2:]
    return x, attn, mlp_w


@pytest.mark.parametrize("case", ROW12_CASES, ids=ROW12_IDS)
def test_int8_rows_on_the_wgmma_stage_match_plain_and_wmma(device, case):
    """Rows 1 and 2 on the wgmma stage (and row 1 on the tensor-core core):
    the bf16 bar against the plain versions; row 2 and row 1's QKV stage bit
    for bit the WMMA forms; a second run bit for bit the first; one counted
    launch each, two of the stage inside each."""
    bsz, seq, width, heads, masked, zero_row = case
    x, attn, mlp_w = _row12_inputs(device, bsz, seq, width, zero_row)
    mask = causal_mask(seq, device=device) if masked else None
    before = (quant.int8_ln_qkv_attention.launches, quant.int8_ln_mlp.launches,
              quant.gemm_stage.launches)
    out1 = quant.int8_ln_qkv_attention(x, *attn, mask, heads=heads)
    out2 = quant.int8_ln_mlp(x, *mlp_w)
    torch.cuda.synchronize()
    assert (quant.int8_ln_qkv_attention.launches, quant.int8_ln_mlp.launches,
            quant.gemm_stage.launches) == (before[0] + 1, before[1] + 1, before[2] + 4)
    _agree(out1, quant.int8_ln_qkv_attention_ref(x, *attn, mask, heads=heads))
    _agree(out2, quant.int8_ln_mlp_ref(x, *mlp_w))
    assert torch.equal(out2, quant._int8_ln_mlp_cuda(x, *mlp_w, 1e-5, 1, "wmma"))
    assert torch.equal(quant._int8_qkv(x, *attn[:5], 1e-5),
                       quant._int8_qkv(x, *attn[:5], 1e-5, "wmma"))
    assert torch.equal(out1, quant.int8_ln_qkv_attention(x, *attn, mask, heads=heads))
    assert torch.equal(out2, quant.int8_ln_mlp(x, *mlp_w))


@pytest.mark.parametrize("rows", [1, 591, 50432 // 64])
@pytest.mark.parametrize("epilogue", sorted(set(quant.STAGE_EPILOGUES)
                                             - {"chunk_residual", "chunk_rowscale", "dot_t"}))
def test_gemm_stage_matches_plain_and_wmma(device, epilogue, rows):
    """The stage alone: the bf16 bar (fp32's for gelu's fp32 y) against its
    plain version, an int8 product bit for bit the WMMA stage, one counted
    launch; rows past the last 128-row tile untouched. The bf16 epilogues
    (out_proj; rows 5 and 10's bias and bias_gelu) sum fp32 in another
    order than the WMMA stage, so they take the bar alone."""
    rng = np.random.default_rng(rows)
    k, n = (3072, 768) if epilogue == "residual" else (768, 2304)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(device,
                                                                               torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    if epilogue in quant.BF16_EPILOGUES:
        a = _randn(device, rows, k, dtype=torch.bfloat16, seed=rows)
        w = (_randn(device, k, n, seed=rows + 1) / 32).to(torch.bfloat16)
        kw = dict(bias=bias, x=x)
    else:
        a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8)).to(device)
        w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(device)
        kw = dict(row_scale=torch.rand(rows, device=device) / 100,
                  col_scale=torch.rand(n, device=device) / 100, bias=bias, x=x)
    before = quant.gemm_stage.launches
    out = quant.gemm_stage(a, w, epilogue, **kw)
    torch.cuda.synchronize()
    assert quant.gemm_stage.launches == before + 1
    ref = quant.gemm_stage_ref(a, w, epilogue, **kw)
    if epilogue == "gelu":
        _f32_agree(out, ref)
    else:
        _agree(out, ref)
    if epilogue not in quant.BF16_EPILOGUES:
        wmma = quant._gemm_stage_cuda(a, w, epilogue, kw["row_scale"], kw["col_scale"], bias, x,
                                      "wmma")
        assert torch.equal(out, wmma)


@pytest.mark.parametrize("n_chunks", [2, 4, 16])
@pytest.mark.parametrize("rows", [1, 591, 50432 // 64])
def test_gemm_stage_chunk_residual_matches_plain(device, rows, n_chunks):
    """Row 3's folded c_proj alone (K = 4096, N = 1024: L/14's c_proj): the
    bf16 bar against its plain version, one counted launch, a second run
    bit for bit the first; rows past the last 128-row tile untouched."""
    rng = np.random.default_rng(rows + n_chunks)
    k, n = 4096, 1024
    a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8)).to(device)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(device)
    kw = dict(row_scale=torch.rand(rows, n_chunks, device=device) / 100,
              col_scale=torch.rand(n, device=device) / 1000,
              bias=_randn(device, n, seed=rows), x=_randn(device, rows, n, dtype=torch.bfloat16),
              n_chunks=n_chunks)
    before = quant.gemm_stage.launches
    out = quant.gemm_stage(a, w, "chunk_residual", **kw)
    torch.cuda.synchronize()
    assert quant.gemm_stage.launches == before + 1
    _agree(out, quant.gemm_stage_ref(a, w, "chunk_residual", **kw))
    assert torch.equal(out, quant.gemm_stage(a, w, "chunk_residual", **kw))


def test_gemm_stage_refuses_what_it_does_not_take(device):
    a = torch.zeros((4, 768), dtype=torch.int8, device=device)
    w = torch.zeros((768, 2304), dtype=torch.int8, device=device)
    with pytest.raises(ValueError):  # N % 128
        quant.gemm_stage(a, w[:, :200], "qkv", row_scale=torch.ones(4, device=device),
                         col_scale=torch.ones(200, device=device),
                         bias=torch.zeros(200, device=device))
    with pytest.raises(TypeError):  # a bf16 operand to an int8 epilogue
        quant.gemm_stage(a.to(torch.bfloat16), w, "gelu")
    with pytest.raises(ValueError):  # the residual without x
        quant.gemm_stage(a, w, "residual", row_scale=torch.ones(4, device=device),
                         col_scale=torch.ones(2304, device=device),
                         bias=torch.zeros(2304, device=device))


def test_int8_engine_chunk_runs_the_wgmma_stage_and_the_mma_core(device):
    """Per image chunk the int8 ViT-B/16 engine launches rows 1 and 2 on the
    wgmma stage and row 1's core as attn_core_mma_kernel, and no WMMA
    gemm_kernel or scalar attn_core_kernel; rows 1-2 launch none either."""
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params

    params = init_clip_params(VIT_B_16, torch.Generator(device=device).manual_seed(0),
                              device=device)
    vocab = [{"image_path": "x.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
              "materials": ["drewno"], "colors": ["biały"], "room_type": "kuchnia"}]
    engine = InteriorAnalyzer(params, VIT_B_16, training_data=vocab, device=device,
                              dtype=torch.bfloat16, quantize=True, wire_format="patch")
    px = np.random.default_rng(10).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    engine.classify_pixels(px)
    names = _cuda_kernels(lambda: engine.classify_pixels(px))
    assert _launched(names, "wgmma_stage_kernel") and _launched(names, "attn_core_mma_kernel")
    assert not _launched(names, "gemm_kernel<") and not _launched(names, "attn_core_kernel<")
    x, attn, mlp_w = _inputs(device, 2, 197, 768)
    for call in (lambda: quant.int8_ln_qkv_attention(x, *attn, heads=12),
                 lambda: quant.int8_ln_mlp(x, *mlp_w)):
        names = _cuda_kernels(call)
        assert _launched(names, "wgmma_stage_kernel") and _launched(names, "rowquant_kernel")
        assert not _launched(names, "gemm_kernel<") and not _launched(names, "attn_core_kernel<")


ROW4_CASES = [(2, 50, 768, 12, False, None), (4, 77, 512, 8, True, None),
              (2, 197, 768, 12, False, ("chunked", 2, 4)),
              (1, 257, 1024, 16, False, ("chunked", 1, 16))]
ROW4_IDS = ["B32_full", "text_full_causal", "B16_chunked", "L14_chunked"]


def _row4_args(device, case):
    bsz, seq, width, heads, masked, override = case
    x, attn, mlp_w = _inputs(device, bsz, seq, width)
    mask = causal_mask(seq, device=device) if masked else None
    plan = override or quant._block_plan(bsz, seq, width, 4 * width, 2)
    n_chunks = plan[2] if plan[0] == "chunked" else 1
    return x, attn + (mask,), mlp_w, heads, override, n_chunks


@pytest.mark.parametrize("case", ROW4_CASES, ids=ROW4_IDS)
def test_rows_3_and_4_keep_the_wmma_forms(device, case):
    """Row 4's form 1 (uncounted) is row 1's WMMA form, then row 2's WMMA
    form (full) or row 3's (chunked), bit for bit; it launches the WMMA
    gemm_kernel and the scalar core and not the wgmma stage."""
    x, attn, mlp_w, heads, override, n_chunks = _row4_args(device, case)
    out = quant._int8_block_cuda(x, attn, mlp_w, heads, 1e-5, n_chunks, "wmma")
    y1 = quant._int8_ln_qkv_attention_cuda(x, *attn, heads, 1e-5, "wmma")
    want = quant._int8_ln_mlp_cuda(y1, *mlp_w, 1e-5, n_chunks, "wmma")
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    names = _cuda_kernels(lambda: quant._int8_block_cuda(x, attn, mlp_w, heads, 1e-5, n_chunks,
                                                         "wmma"))
    assert _launched(names, "gemm_kernel<") and _launched(names, "attn_core_kernel<")
    assert not _launched(names, "wgmma_stage_kernel")


@pytest.mark.parametrize("case", ROW4_CASES, ids=ROW4_IDS)
def test_rows_3_and_4_on_the_wgmma_stage(device, case):
    """Row 4 through its wrapper (one counted launch, four of the stage) is
    row 1's form 0, then row 2's (full) or row 3's (chunked) form 0, bit for
    bit; row 3's form 0 (two of the stage) is its WMMA form 1 bit for bit,
    on y1; both launch the wgmma stage and the tensor-core core and no WMMA
    gemm_kernel, scalar core or chunk-sum pass."""
    x, attn, mlp_w, heads, override, n_chunks = _row4_args(device, case)
    before = (quant.int8_block.launches, quant.gemm_stage.launches)
    out = quant.int8_block(x, *attn, *mlp_w, heads=heads, plan_override=override)
    torch.cuda.synchronize()
    assert (quant.int8_block.launches, quant.gemm_stage.launches) == (before[0] + 1,
                                                                       before[1] + 4)
    y1 = quant._int8_ln_qkv_attention_cuda(x, *attn, heads, 1e-5)
    row23 = quant._int8_ln_mlp_cuda(y1, *mlp_w, 1e-5, n_chunks)
    torch.cuda.synchronize()
    assert torch.equal(out, row23)
    if n_chunks > 1:
        before = (quant.int8_ln_mlp_chunked.launches, quant.gemm_stage.launches)
        row3 = quant.int8_ln_mlp_chunked(y1, *mlp_w, n_chunks=n_chunks)
        torch.cuda.synchronize()
        assert (quant.int8_ln_mlp_chunked.launches, quant.gemm_stage.launches) == (
            before[0] + 1, before[1] + 2)
        assert torch.equal(row3, row23)
        assert torch.equal(row3, quant._int8_ln_mlp_cuda(y1, *mlp_w, 1e-5, n_chunks, "wmma"))
    for call in (lambda: quant.int8_block(x, *attn, *mlp_w, heads=heads, plan_override=override),
                 lambda: quant._int8_ln_mlp_cuda(y1, *mlp_w, 1e-5, n_chunks)):
        names = _cuda_kernels(call)
        assert _launched(names, "wgmma_stage_kernel")
        for needle in ("gemm_kernel<", "attn_core_kernel<", "mlp_chunk_sum_kernel"):
            assert not _launched(names, needle)


def test_rows_3_and_4_refuse_a_chunk_off_the_stage_slices(device):
    """B/16's hidden axis in 16 chunks (4W/C = 192) is not a whole number of
    the stage's 128-deep K-slices: the wrappers raise before a launch."""
    x, attn, mlp_w = _inputs(device, 1, 197, 768)
    before = dict(_build.launch_counts())
    with pytest.raises(ValueError, match="multiple of 128"):
        quant.int8_ln_mlp_chunked(x, *mlp_w, n_chunks=16)
    with pytest.raises(ValueError, match="multiple of 128"):
        quant.int8_block(x, *attn, None, *mlp_w, heads=12, plan_override=("chunked", 1, 16))
    assert _build.launch_counts() == before


# Rows 5 and 10 (bf16) at the shapes the bf16 engines launch them: ViT-B/16
# at B = 1 and 3 (B*S not a multiple of 128), the text tower's 52 prompts
# (W = 512, causal), a zero LN row.
ROW5_CASES = [(1, 197, 768, 12, False, False), (3, 197, 768, 12, False, False),
              (52, 77, 512, 8, True, False), (2, 197, 768, 12, False, True)]
ROW5_IDS = ["image_B1", "image_B3", "text_B52_causal", "image_B2_zero_row"]


def _bf16_row_args(device, case):
    bsz, seq, width, heads, masked, zero_row = case
    x, attn, mlp_w = _row12_inputs(device, bsz, seq, width, zero_row)
    rng = np.random.default_rng(bsz + width)
    w = lambda *s, std: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * std).astype(np.float32)).to(device, torch.bfloat16)
    mask = causal_mask(seq, device=device) if masked else None
    attn_b = (x, *attn[:2], w(width, 3 * width, std=width ** -0.5), attn[4], attn[5], attn[6],
              mask)
    mlp_b = (x, *mlp_w[:2], w(width, 4 * width, std=(2 * width) ** -0.5), mlp_w[4],
             w(4 * width, width, std=0.01), mlp_w[7])
    return attn_b, mlp_b, heads


@pytest.mark.parametrize("case", ROW5_CASES, ids=ROW5_IDS)
def test_bf16_rows_on_the_wgmma_stage_match_plain_and_wmma(device, case):
    """Rows 5 and 10 through their wrappers (form 0: the wgmma stage, row 5's
    core on the tensor-core core): the bf16 bar against the plain versions
    and against the WMMA form 1 (another fp32 summation order); a second run
    bit for bit the first; one counted launch each and none of the stage's
    own count."""
    attn_b, mlp_b, heads = _bf16_row_args(device, case)
    before = (attention.fused_ln_qkv_attention.launches, mlp.fused_ln_mlp.launches,
              quant.gemm_stage.launches)
    out5 = attention.fused_ln_qkv_attention(*attn_b, heads=heads)
    out10 = mlp.fused_ln_mlp(*mlp_b)
    torch.cuda.synchronize()
    assert (attention.fused_ln_qkv_attention.launches, mlp.fused_ln_mlp.launches,
            quant.gemm_stage.launches) == (before[0] + 1, before[1] + 1, before[2])
    _agree(out5, attention.fused_ln_qkv_attention_ref(*attn_b, heads=heads))
    _agree(out10, mlp.fused_ln_mlp_ref(*mlp_b))
    old5 = attention._fused_ln_qkv_attention_cuda(*attn_b, heads, 1e-5, "wmma")
    old10 = mlp._fused_ln_mlp_cuda(*mlp_b, 1e-5, "wmma")
    torch.cuda.synchronize()
    _agree(out5, old5)
    _agree(out10, old10)
    assert torch.equal(out5, attention.fused_ln_qkv_attention(*attn_b, heads=heads))
    assert torch.equal(out10, mlp.fused_ln_mlp(*mlp_b))


def test_bf16_rows_keep_their_forms_apart(device):
    """Form 0 of rows 5 and 10 launches the LN row pass, the wgmma stage and
    (row 5) the tensor-core core, and no WMMA gemm_kernel or scalar core;
    form 1 (uncounted) launches those and not the stage."""
    attn_b, mlp_b, heads = _bf16_row_args(device, ROW5_CASES[1])
    for route, wmma in (
            (lambda: attention.fused_ln_qkv_attention(*attn_b, heads=heads),
             lambda: attention._fused_ln_qkv_attention_cuda(*attn_b, heads, 1e-5, "wmma")),
            (lambda: mlp.fused_ln_mlp(*mlp_b), lambda: mlp._fused_ln_mlp_cuda(*mlp_b, 1e-5,
                                                                              "wmma"))):
        names = _cuda_kernels(route)
        assert _launched(names, "wgmma_stage_kernel") and _launched(names, "ln_rows_kernel")
        assert not _launched(names, "gemm_kernel<") and not _launched(names, "attn_core_kernel<")
        before = dict(_build.launch_counts())
        names = _cuda_kernels(wmma)
        assert _build.launch_counts() == before
        assert _launched(names, "gemm_kernel<") and not _launched(names, "wgmma_stage_kernel")
    names = _cuda_kernels(lambda: attention.fused_ln_qkv_attention(*attn_b, heads=heads))
    assert _launched(names, "attn_core_mma_kernel")
    names = _cuda_kernels(lambda: attention._fused_ln_qkv_attention_cuda(*attn_b, heads, 1e-5,
                                                                          "wmma"))
    assert _launched(names, "attn_core_kernel<")


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_mlp"])
def test_bf16_engine_chunks_run_the_wgmma_stage_and_the_mma_core(device, attn_impl):
    """Per image chunk the bf16 ViT-B/16 engines (the worker's default and
    ``pallas_mlp``) launch rows 5 (and 10) on the wgmma stage and row 5's
    core as attn_core_mma_kernel, and no WMMA gemm_kernel or scalar
    attn_core_kernel."""
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params

    params = init_clip_params(VIT_B_16, torch.Generator(device=device).manual_seed(0),
                              device=device)
    vocab = [{"image_path": "x.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
              "materials": ["drewno"], "colors": ["biały"], "room_type": "kuchnia"}]
    engine = InteriorAnalyzer(params, VIT_B_16, training_data=vocab, device=device,
                              dtype=torch.bfloat16, quantize=False, wire_format="hwc",
                              attn_impl=attn_impl)
    px = np.random.default_rng(11).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    engine.classify_pixels(px)
    names = _cuda_kernels(lambda: engine.classify_pixels(px))
    assert _launched(names, "wgmma_stage_kernel") and _launched(names, "attn_core_mma_kernel")
    assert not _launched(names, "gemm_kernel<") and not _launched(names, "attn_core_kernel<")


def test_bench_program_past_the_engine_cap(device):
    """``tools/torch_bench.py``'s program (int8 ViT-B/16 on the patch wire,
    called directly as the tool calls it) at B=4096, 8x the engine's 512-row
    cap, with c_fc's output past 2^31 elements: every score finite, and its
    first 256 rows give the verdicts, the top-5 and the scores (within
    ``ROW_TOL``) of the same rows in a B=256 call."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_bench.py")
    spec = importlib.util.spec_from_file_location("torch_bench", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    bench = tool.setup("vit_b_16", "2", "patch", device, np.random.default_rng(0))
    px = torch.from_numpy(bench["make_batch"](4096)).to(device)
    big, _ = bench["classify"](px)
    small, _ = bench["classify"](px[:256])
    got = tool.row_agreement(big, small)
    assert got["ok"] and got["of"] == 4096, got
