"""Sharding rules and the sharded programs — the port of
``aiic_tpu.parallel.sharding``.

Tensor-parallel layout (Megatron, per tower, blocks stacked on a leading
layer axis L), as DTensor placements over the mesh's ``("data", "model")``:

==================  ==========================  ==============================
param               shape                       placements (data, model)
==================  ==========================  ==============================
attn.wqkv / bqkv    (L, W, 3W) / (L, 3W)        (R, Shard(2)) / (R, Shard(1))
attn.wo             (L, W, W)                   (R, Shard(1))  row-parallel
mlp.w1 / b1         (L, W, M) / (L, M)          (R, Shard(2)) / (R, Shard(1))
mlp.w2              (L, M, W)                   (R, Shard(1))  row-parallel
everything else     —                           (R, R)
==================  ==========================  ==============================

The QKV columns are regrouped per model rank before they are split
(``shard_of``), so that a rank's shard is the Q, K and V columns of its
H/tp heads, as Megatron lays them out. LoRA adapters follow their host
weight: the A factor is replicated (rank is tiny) where the input is whole,
the B factor shards like the weight's output columns.

Where XLA's GSPMD derives the collectives in the JAX package, they are
written here (:class:`TensorParallel`): a column-parallel product's input
passes through an identity whose backward all-reduces over ``"model"``
(``copy_to_model``), a row-parallel product's partial sums all-reduce
forward with an identity backward (``reduce_from_model``). The kernels run
data-parallel instead (``make_sharded_classify_fn(kernels=True)``, the
trainer's kernel text paths): each rank runs the single-device program on
its rows with replicated weights, then the rows are gathered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from aiic_tpu_torch.adapters.lora import ATTACH_POINTS
from aiic_tpu_torch.models.clip import (
    _gelu, _mm, layer_norm, linear, lora_dropout_apply, resolve_attn_impl,
)
from aiic_tpu_torch.ops.attention import attention_qkv_ref
from aiic_tpu_torch.parallel.mesh import all_gather, all_gather_start, all_reduce, mesh_device

Params = Dict[str, Any]
Spec = Tuple[Placement, Placement]

REPL: Spec = (Replicate(), Replicate())
QKV_LEAVES = ("wqkv", "bqkv")


def _on_model(dim: int) -> Spec:
    return (Replicate(), Shard(dim))


def _map(fn, tree, *rest, key: str = ""):
    """``fn(leaf, *rest_leaves, key)`` over nested dicts (a spec tuple is a
    leaf); ``key`` is the leaf's own name."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), key=k) for k, v in tree.items()}
    return fn(tree, *rest, key)


def _replicate(tree):
    return _map(lambda _leaf, _key: REPL, tree)


def _tower_block_pspecs() -> Params:
    return {
        "ln1": {"scale": REPL, "bias": REPL},
        "ln2": {"scale": REPL, "bias": REPL},
        "attn": {"wqkv": _on_model(2), "bqkv": _on_model(1), "wo": _on_model(1), "bo": REPL},
        "mlp": {"w1": _on_model(2), "b1": _on_model(1), "w2": _on_model(1), "b2": REPL},
    }


def param_pspecs(params: Params, *, replicate_visual: bool = False,
                 replicate_text: bool = False) -> Params:
    """Placement tree matching a CLIP param tree.

    ``replicate_visual``: keep the whole image tower replicated instead of
    TP-sharded, for a frozen tower that runs data-parallel with its kernels
    (the trainer's image branch under a mesh). ``replicate_text``: the same
    for the text tower, when the DIFFERENTIATED tower runs data-parallel on
    a kernel text path."""
    visual_blocks = _tower_block_pspecs()
    if replicate_visual:
        visual_blocks = _replicate(visual_blocks)
    visual = {
        "patch_embed": REPL if replicate_visual else _on_model(1),
        "cls": REPL,
        "pos": REPL,
        "ln_pre": {"scale": REPL, "bias": REPL},
        "blocks": visual_blocks,
        "ln_post": {"scale": REPL, "bias": REPL},
        "proj": REPL,
    }
    text_blocks = _tower_block_pspecs()
    if replicate_text:
        text_blocks = _replicate(text_blocks)
    specs = {
        "visual": visual,
        "text": {
            "tok_embed": REPL,
            "pos": REPL,
            "blocks": text_blocks,
            "ln_final": {"scale": REPL, "bias": REPL},
            "proj": REPL,
        },
        "logit_scale": REPL,
    }
    # int8 weight trees (ops.quant: blocks['mlp_q'] / blocks['attn_q']) and
    # the int8 folded patch embed replicate: only the data-parallel kernel
    # programs read them, and those need the full tensors on every rank.
    for tower in ("visual", "text"):
        blocks = params.get(tower, {}).get("blocks", {})
        for qk in ("mlp_q", "attn_q"):
            if qk in blocks:
                specs[tower]["blocks"][qk] = _replicate(blocks[qk])
    if "patch_embed_q" in params.get("visual", {}):
        specs["visual"]["patch_embed_q"] = _replicate(params["visual"]["patch_embed_q"])
    return specs


def lora_pspecs(lora_tree: Params, *, replicate: bool = False) -> Params:
    """A replicated, B sharded like its host weight's output dimension.
    ``replicate=True`` (kernel text paths, which run data-parallel):
    everything replicated."""
    if replicate:
        per_point = {k: {"A": REPL, "B": REPL} for k in ("c_fc", "c_proj", "out_proj")}
    else:
        per_point = {
            "c_fc": {"A": REPL, "B": _on_model(2)},      # B: (L, r, M)
            "c_proj": {"A": _on_model(1), "B": REPL},    # A: (L, M, r)
            "out_proj": {"A": REPL, "B": REPL},
        }
    return {k: per_point[k] for k in lora_tree}


def _opt_state_pspecs(opt_state: Params, lora_tree: Params, lspec: Params) -> Params:
    """Optimizer-state leaves shaped like an adapter leaf take that leaf's
    placements; the step count and anything else replicate."""
    shape_to_spec = {}
    _map(lambda leaf, sp, _key: shape_to_spec.__setitem__(tuple(leaf.shape), sp),
         lora_tree, lspec)
    return _map(lambda x, _key: shape_to_spec.get(tuple(x.shape), REPL)
                if isinstance(x, torch.Tensor) else REPL, opt_state)


# ---------------------------------------------------------------------------
# Shards of full tensors, and trees of DTensors
# ---------------------------------------------------------------------------


def shard_of(t: torch.Tensor, spec: Spec, mesh: DeviceMesh, key: str = "") -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec``. The QKV
    leaves are regrouped per model rank first (a rank's shard is the Q, K
    and V columns of its heads)."""
    place = spec[1]
    n = mesh.size(1)
    if not isinstance(place, Shard) or n == 1:
        return t
    r, dim = mesh.get_local_rank("model"), place.dim
    if t.shape[dim] % (3 * n if key in QKV_LEAVES else n):
        raise ValueError(f"{key} {tuple(t.shape)}: axis {dim} does not split over tp={n}")
    if key in QKV_LEAVES:
        return t.unflatten(dim, (3, n, -1)).select(dim + 1, r).flatten(dim, dim + 1).contiguous()
    return t.chunk(n, dim)[r].contiguous()


def local_tree(tree, specs, mesh: DeviceMesh):
    """The rank's local tensors of a tree: a DTensor's local piece, a full
    tensor's shard under its spec (non-tensor leaves pass through)."""
    def leaf(x, sp, key):
        if isinstance(x, DTensor):
            return x.to_local()
        if isinstance(x, torch.Tensor):
            return shard_of(x.to(mesh_device(mesh)), sp, mesh, key)
        return x
    return _map(leaf, tree, specs)


def distribute_tree(local, specs, mesh: DeviceMesh):
    """Local pieces -> DTensors with their placements (no communication)."""
    return _map(lambda x, sp, _key: DTensor.from_local(x, mesh, sp, run_check=False)
                if isinstance(x, torch.Tensor) else x, local, specs)


def full_tree(tree):
    """Whole tensors of a tree of DTensors, each rank's pieces gathered over
    the axes they shard (an adapter or optimizer tree: no QKV leaves)."""
    def leaf(x, _key):
        if not isinstance(x, DTensor):
            return x
        t = x.to_local()
        for axis, place in zip(("data", "model"), x.placements):
            if isinstance(place, Shard):
                t = all_gather(t, x.device_mesh.get_group(axis), dim=place.dim)
        return t
    return _map(leaf, tree)


def shard_params(params: Params, mesh: DeviceMesh) -> Params:
    specs = param_pspecs(params)
    return distribute_tree(local_tree(params, specs, mesh), specs, mesh)


# ---------------------------------------------------------------------------
# The collectives under autograd
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the cotangent backward: the input of a
    column-parallel product (each rank's product sees part of its
    cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """All-gather of rows forward; the member's own rows of the cotangent
    backward. Every member takes the same loss on the gathered rows, so the
    gradient of its rows is its slice of that cotangent, taken once: the
    adapter gradients are then summed over the group once."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.rows, ctx.index = x.shape[0], index
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, group, index: int) -> torch.Tensor:
    return _GatherRows.apply(x, group, index)


def _up(down: torch.Tensor, b: torch.Tensor, scaling: float, dtype) -> torch.Tensor:
    """The second half of ``models.clip.lora_delta``: the up-projection of
    a down-projection (fp32 sums), scaled, in the compute dtype."""
    return (_mm(down.to(dtype), b.to(dtype)) * scaling).to(dtype)


class TensorParallel:
    """The Megatron block over the mesh's ``"model"`` group, on this rank's
    shards (``shard_of``) of a tower's weights and adapters: column-parallel
    QKV (H/tp heads a rank) and c_fc, row-parallel out-proj and c_proj with
    the all-reduce over ``"model"``. It runs the plain composition
    (``attn_impl="xla"``), as GSPMD partitions only that path in the JAX
    package; the kernels run data-parallel."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("model")
        self.size = mesh.size(1)
        self.rank = mesh.get_local_rank("model")

    def _local_heads(self, heads: int) -> int:
        if heads % self.size:
            raise ValueError(f"{heads} heads do not split over tp={self.size}")
        return heads // self.size

    def full_width(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """A column-sharded activation (the image embed) made whole."""
        return x if x.shape[-1] == width else all_gather(x, self.group, dim=-1)

    def block(self, x, p, heads, mask, gelu_type, attn_impl="xla", *, lora=None,
              lora_scaling=1.0, lora_dropout=0.0, lora_generator=None, lora_rows=None):
        """``models.clip.block``'s plain path, tensor-parallel."""
        if resolve_attn_impl(attn_impl, x.device.type) != "xla":
            raise ValueError(f"tensor parallelism runs the plain composition (attn_impl='xla'), "
                             f"not {attn_impl!r}: the kernels run data-parallel")
        g, n, r, dt = self.group, self.size, self.rank, x.dtype
        lora = lora or {}
        l_out, l_fc, l_proj = (lora.get(k) for k in ATTACH_POINTS)
        gen = lora_generator if lora_dropout > 0.0 else None

        def drop(d, cols=None):
            return d if gen is None else lora_dropout_apply(d, lora_dropout, gen, lora_rows, cols)

        a, mlp = p["attn"], p["mlp"]
        h = layer_norm(x, p["ln1"])
        o = attention_qkv_ref(linear(copy_to_model(h, g), a["wqkv"], a["bqkv"]), mask,
                              self._local_heads(heads))
        y = (reduce_from_model(_mm(o, a["wo"].to(dt)), g) + a["bo"].float()).to(dt)
        if l_out is not None:
            k = o.shape[-1]  # this rank's rows of the replicated A
            a_rows = copy_to_model(l_out["A"], g)[r * k:(r + 1) * k]
            down = reduce_from_model(_mm(o, a_rows.to(dt)), g)
            y = y + drop(_up(down, l_out["B"], lora_scaling, dt))
        x = x + y

        h = layer_norm(x, p["ln2"])
        u = linear(copy_to_model(h, g), mlp["w1"], mlp["b1"])
        if l_fc is not None:
            down = copy_to_model(_mm(h, l_fc["A"].to(dt)), g)
            m = u.shape[-1]
            u = u + drop(_up(down, l_fc["B"], lora_scaling, dt), cols=(r * m, n * m))
        u = _gelu(u, gelu_type)
        y = (reduce_from_model(_mm(u, mlp["w2"].to(dt)), g) + mlp["b2"].float()).to(dt)
        if l_proj is not None:
            down = reduce_from_model(_mm(u, l_proj["A"].to(dt)), g)
            y = y + drop(_up(down, l_proj["B"], lora_scaling, dt))
        return x + y

    def block_cls(self, x, p, heads, gelu_type):
        """``models.clip.block_cls`` (the last image block for the CLS row,
        fp32 after the projections), tensor-parallel."""
        g = self.group
        bsz, seq, width = x.shape
        hl, k = self._local_heads(heads), width // self.size
        dim = width // heads

        h = layer_norm(x, p["ln1"])
        wqkv = p["attn"]["wqkv"].to(h.dtype)
        bqkv = p["attn"]["bqkv"].float()
        q = _mm(h[:, 0], wqkv[:, :k]) + bqkv[:k]
        kv = _mm(h, wqkv[:, k:]) + bqkv[k:]
        qh = q.reshape(bsz, hl, dim)
        kh = kv[..., :k].reshape(bsz, seq, hl, dim)
        vh = kv[..., k:].reshape(bsz, seq, hl, dim)
        scores = torch.einsum("bhd,bkhd->bhk", qh * dim ** -0.5, kh)
        attn = torch.einsum("bhk,bkhd->bhd", torch.softmax(scores, dim=-1), vh).reshape(bsz, k)

        out = reduce_from_model(_mm(attn, p["attn"]["wo"]), g)
        cls = x[:, 0].float() + out + p["attn"]["bo"].float()
        m = layer_norm(cls, p["ln2"])
        m = _mm(m, p["mlp"]["w1"]) + p["mlp"]["b1"].float()
        m = _gelu(m, gelu_type)
        m = reduce_from_model(_mm(m, p["mlp"]["w2"]), g) + p["mlp"]["b2"].float()
        return cls + m


# ---------------------------------------------------------------------------
# The sharded programs
# ---------------------------------------------------------------------------


def batch_rows(x, n: int, i: int) -> torch.Tensor:
    """Rows i of n equal shards of a global batch: a DTensor's local piece
    (``host_local_batch``), or the slice of a tensor that every rank holds
    whole."""
    if isinstance(x, DTensor):
        return x.to_local()
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n} ranks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def make_sharded_classify_fn(mesh: DeviceMesh, classify_fn: Callable, params: Params, *,
                             kernels: bool = False) -> Callable:
    """Wrap the engine's classify program (``classify_fn(params, pixels,
    det_text, cat_text, cat_mask)``, e.g. a ``functools.partial`` of
    ``engine.programs.classify_batch``) for the mesh. Every rank calls the
    result with the same global batch and gets the whole batch's outputs.

    ``kernels=True`` (the serving configurations): every mesh axis is data.
    Each rank runs the single-device program, kernels included, on its
    slice of the batch with replicated weights; the outputs are gathered.
    The batch must divide by the mesh size (the engine's buckets do).

    ``kernels=False``: weights sharded per ``param_pspecs`` (``params`` is
    the full tree or ``shard_params``'s), rows over ``"data"``, the image
    tower's blocks tensor-parallel over ``"model"`` (:class:`TensorParallel`,
    the plain composition only); the outputs are gathered over ``"data"``.

    The result has ``.local`` (the rank's program on its rows of the batch,
    which it copies to its device: the dispatch) and ``.gather_start`` (the
    collective, the fetch: issued, its wait returned) as attributes."""
    dev = mesh_device(mesh)
    if kernels:
        # the gather runs over the world, in global rank order
        n, i, group = mesh.size(), dist.get_rank(), None

        def local(params, pixels, det_text, cat_text, cat_mask):
            rows = batch_rows(pixels, n, i).to(dev, non_blocking=True)
            return classify_fn(_map(lambda x, _k: _local(x), params), rows,
                               _local(det_text), _local(cat_text), _local(cat_mask))
    else:
        specs = param_pspecs(params)
        tp = TensorParallel(mesh)
        n, i, group = mesh.size(0), mesh.get_local_rank("data"), mesh.get_group("data")

        def local(params, pixels, det_text, cat_text, cat_mask):
            rows = batch_rows(pixels, n, i).to(dev, non_blocking=True)
            return classify_fn(local_tree(params, specs, mesh), rows,
                               _local(det_text), _local(cat_text), _local(cat_mask), tp=tp)

    def gather_start(res: Dict[str, torch.Tensor]) -> Callable[[], Dict[str, torch.Tensor]]:
        waits = {k: all_gather_start(v, group) for k, v in res.items()}
        return lambda: {k: wait() for k, wait in waits.items()}

    def sharded(params, pixels, det_text, cat_text, cat_mask):
        return gather_start(local(params, pixels, det_text, cat_text, cat_mask))()

    sharded.local, sharded.gather_start = local, gather_start
    return sharded


def shard_train_step(mesh: DeviceMesh, train_step: Callable, eval_step: Callable,
                     params: Params, lora_tree: Params, opt_state, *,
                     replicate_visual: Optional[bool] = None,
                     replicate_text: Optional[bool] = None):
    """The train and eval steps of ``make_train_step(mesh=mesh)``, and the
    states as DTensors with their placements -> (train_step, eval_step,
    params, lora_tree, opt_state). Batch inputs shard on ``"data"``: a
    ``host_local_batch`` DTensor, or the global batch whole on every rank.

    The steps are explicit programs built for one layout, which
    ``make_train_step`` fixes (its ``replicate_visual`` and
    ``replicate_text``); the states are placed for that layout. A layout
    given here must be the step's."""
    if getattr(train_step, "mesh", None) is not mesh:
        raise ValueError("shard_train_step takes the steps of make_train_step(mesh=mesh)")
    for name, want in (("replicate_visual", replicate_visual),
                       ("replicate_text", replicate_text)):
        if want is not None and want != train_step.layout[name]:
            raise ValueError(f"the step was built with {name}={train_step.layout[name]}; "
                             f"pass {name}={want} to make_train_step")
    pspec, lspec, ospec = train_step.placements(params, lora_tree, opt_state)
    return (train_step, eval_step,
            distribute_tree(local_tree(params, pspec, mesh), pspec, mesh),
            distribute_tree(local_tree(lora_tree, lspec, mesh), lspec, mesh),
            distribute_tree(local_tree(opt_state, ospec, mesh), ospec, mesh))
