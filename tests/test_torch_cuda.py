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
take the bf16 bar, rows that are zero in the plain version equal; maconly
is exact (integer products and one fp32 add), and the three schedules of
kernel_experiments5.py give row 1's kernel output bit for bit.
"""

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
    """Names of the CUDA kernels that fn() launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


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


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_text_block_backwards_keep_their_core(device, path):
    """Rows 12 and 14 (text_block_bwd, text_block_bwd_int8) still run
    common.cuh's block_core_bwd_kernel, not the tensor-core backward, and
    repeat themselves bit for bit across two calls."""
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
    assert _launched(names, "block_core_bwd_kernel") and not _launched(names, "core_bwd_mma")
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for p in first[1]:
        for ab in "AB":
            assert torch.equal(first[1][p][ab], second[1][p][ab])


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


@pytest.mark.parametrize("wrapper,variant", VARIANT_CASES, ids=[f"{w}-{v}" for w, v in VARIANT_CASES])
def test_variant_kernels_match_plain(device, variant_layer, wrapper, variant):
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((2, 197, 768), generator=gen, device=device)
    x[0, 0] = 0.0
    x = x.to(torch.bfloat16)
    fn = variants.WRAPPERS[wrapper]
    before = fn.launches
    out = fn(x, variant_layer, variant)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = variants.PLAIN[wrapper](x, variant_layer, variant)
    if variant == "maconly":
        assert torch.equal(out, ref)
        return
    o, r = out.flatten(0, -2), ref.flatten(0, -2)
    zero = ~r.bool().any(dim=-1)
    assert torch.equal(o[zero], r[zero])
    _agree(o[~zero], r[~zero])
    if wrapper == "attn_var5":
        lp = variant_layer
        row1 = quant.int8_ln_qkv_attention(x, lp["ln1_s"], lp["ln1_b"], lp["wqkv_q"], lp["sqkv"],
                                           lp["bqkv"], lp["wo"], lp["bo"], None, heads=lp["heads"])
        assert torch.equal(out, row1)


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
