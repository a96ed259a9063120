"""The yardstick's arithmetic: published peaks of one H100 and the operations
and bytes of the work each cell asks for, counted from the configuration's
shapes.

Counting rules, for every product: operations are 2·M·K·N; bytes count
each input read once and each output written once at the width it is
stored in, and where the stored width is not certain the narrower one is
counted, so that a bound never comes out longer than the least time. A
product's least time is max(ops / peak of its precision, bytes / HBM
bandwidth). The attention core counts QK^T and PV (4·S^2·W per sequence
and layer, the causal half where a mask removes the rest) and q, k, v
read once and o written once.

Each product names where it runs: ``stage`` (the program's wgmma GEMM
stage, kernels named ``wgmma_stage_kernel``), ``attn_core`` (the
tensor-core attention core, ``attn_core_mma_kernel``) or ``other``
(cuBLAS, the CLS-row last block, the heads).
"""

from __future__ import annotations

from typing import List, NamedTuple

# NVIDIA H100 SXM5 data sheet, dense: bf16 989.4 TFLOP/s, int8 1,978.9 TOP/s,
# fp32 outside the tensor cores 66.9 TFLOP/s; HBM3 3.35 TB/s. At the full
# power limit of 700 W.
PEAK = {"bf16": 989.4e12, "int8": 1978.9e12, "fp32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12


class Product(NamedTuple):
    where: str
    prec: str
    ops: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.ops / PEAK[self.prec], self.bytes / HBM_BYTES_PER_S)


def gemm(where: str, prec: str, m: int, k: int, n: int, a_bytes: int, b_bytes: int,
         out_bytes: int, extra_bytes: float = 0.0) -> Product:
    return Product(where, prec, 2.0 * m * k * n,
                   m * k * a_bytes + k * n * b_bytes + m * n * out_bytes + extra_bytes)


def image_call(cfg: dict, engine: dict, batch: int) -> List[Product]:
    """The products of one classify call of ``batch`` crops on the serving
    engine ``engine`` (the configuration's ``engine`` options)."""
    p, w, layers = cfg["patch_size"], cfg["vision_width"], cfg["vision_layers"]
    n = (cfg["image_size"] // p) ** 2
    s, e, pdim = n + 1, cfg["embed_dim"], 3 * p * p
    rows = batch * s
    mlp = w * cfg["mlp_ratio"]
    int8 = engine.get("quantize", False) and engine.get("dtype") == "bfloat16"
    out: List[Product] = []
    if int8:  # the int8 folded embed runs as float32 products over depth slices
        out.append(gemm("other", "fp32", batch * n, pdim, w, 1, 1, 4))
    else:
        out.append(gemm("other", "bf16", batch * n, pdim, w, 2, 2, 2))
    core = Product("attn_core", "bf16", 4.0 * batch * s * s * w, 4.0 * rows * w * 2)
    for _ in range(layers - 1):
        if int8:  # row 1 then row 3: int8 QKV, bf16 out-projection, int8 MLP
            out.append(gemm("stage", "int8", rows, w, 3 * w, 1, 1, 2))
            out.append(core)
            out.append(gemm("stage", "bf16", rows, w, w, 2, 2, 2, rows * w * 2))
            out.append(gemm("stage", "int8", rows, w, mlp, 1, 1, 1))
            out.append(gemm("stage", "int8", rows, mlp, w, 1, 1, 2, rows * w * 2))
        else:  # row 5 (QKV and out-projection on the stage), cuBLAS MLP
            out.append(gemm("stage", "bf16", rows, w, 3 * w, 2, 2, 2))
            out.append(core)
            out.append(gemm("stage", "bf16", rows, w, w, 2, 2, 2, rows * w * 2))
            out.append(gemm("other", "bf16", rows, w, mlp, 2, 2, 2))
            out.append(gemm("other", "bf16", rows, mlp, w, 2, 2, 2))
    # the last block on the CLS row: K and V from every row in bf16, the rest
    # in float32; then ln_post, the projection and the two heads
    out.append(gemm("other", "bf16", rows, w, 2 * w, 2, 2, 4))
    out.append(gemm("other", "fp32", batch, w, w, 4, 4, 4))
    out.append(Product("other", "fp32", 4.0 * batch * s * w, 2.0 * rows * w * 4))
    out.append(gemm("other", "fp32", batch, w, w, 4, 4, 4))
    out.append(gemm("other", "fp32", batch, w, mlp, 4, 4, 4))
    out.append(gemm("other", "fp32", batch, mlp, w, 4, 4, 4))
    out.append(gemm("other", "fp32", batch, w, e, 4, 4, 4))
    prompts = 40 + sum(len(v) for v in _vocab(cfg).values())
    out.append(gemm("other", "fp32", batch, e, prompts, 4, 4, 4))
    return out


def _vocab(cfg: dict) -> dict:
    from h100_bench.reference.clip_ref import categories

    return categories(cfg["vocabulary"])


def train_step(cfg: dict, train: dict, batch: int) -> List[Product]:
    """The products of one LoRA step on the text tower (rows 11-12: each
    block's forward on the stage, its backward recomputing the QKV,
    out-projection and c_fc products, then four products against the
    weights), with cached image features. The model's operations, without
    the recomputation and the unneeded product, are those with ``where``
    not in ("recompute", "unneeded"); the stage runs those with ``where``
    in ("stage", "recompute", "unneeded")."""
    w, layers, ctx = cfg["text_width"], cfg["text_layers"], cfg["context_length"]
    mlp, r = w * cfg["mlp_ratio"], train["rank"]
    rows = batch * ctx
    out: List[Product] = []
    causal_pairs = ctx * (ctx + 1) / 2.0
    for layer in range(layers):
        fwd = [gemm("stage", "bf16", rows, w, 3 * w, 2, 2, 2),
               gemm("stage", "bf16", rows, w, w, 2, 2, 2, rows * w * 2),
               gemm("stage", "bf16", rows, w, mlp, 2, 2, 2),
               gemm("stage", "bf16", rows, mlp, w, 2, 2, 2, rows * w * 2)]
        out += fwd
        out += [p._replace(where="recompute") for p in fwd[:3]]
        out += [gemm("stage", "bf16", rows, w, mlp, 2, 2, 2),      # dy . W2^T
                gemm("stage", "bf16", rows, mlp, w, 2, 2, 2),      # dfq . W1^T
                gemm("stage", "bf16", rows, w, w, 2, 2, 2)]        # dy1 . Wo^T
        # dqkv . Wqkv^T and the core backward feed only earlier blocks: the
        # first block's are work the loss does not need (the stage runs the
        # product all the same, counted apart)
        back_qkv = gemm("stage", "bf16", rows, 3 * w, w, 2, 2, 2)
        out.append(back_qkv if layer else back_qkv._replace(where="unneeded"))
        core_ops = 4.0 * batch * causal_pairs * w
        out.append(Product("core", "bf16", core_ops, 4.0 * rows * w * 2))
        if layer:
            out.append(Product("core", "bf16", 2.0 * core_ops, 8.0 * rows * w * 2))
        for din, dout in ((w, w), (w, mlp), (mlp, w)):  # LoRA: forward, both grads, dX
            out.append(gemm("rank", "bf16", rows, din, r, 2, 2, 2))
            out.append(gemm("rank", "bf16", rows, r, dout, 2, 2, 2))
            out.append(Product("rank", "bf16", 2.0 * 2 * rows * r * (din + dout), 0.0))
    out.append(gemm("other", "fp32", batch, w, cfg["embed_dim"], 4, 4, 4))
    return out


def least_s(products, where=None, exclude=()) -> float:
    return sum(p.least_s for p in products
               if (where is None or p.where in where) and p.where not in exclude)


def peak_s(products, exclude=()) -> float:
    """Least time of the products' operations alone at the peaks of their
    precisions (what ``mfu`` divides by the window)."""
    return sum(p.ops / PEAK[p.prec] for p in products if p.where not in exclude)
