"""LoRA contrastive fine-tuning of the text tower — the port of
``aiic_tpu.train.trainer``.

The reference training loop (train_lora.py:167-303) as an eager PyTorch step
over the adapter tree only: the backbone never receives gradients (its
tensors never require them), the port's form of the reference's "train only
params with 'lora' in name" (train_lora.py:194-197).

- frozen image tower: features under ``torch.no_grad`` (reference no_grad at
  train_lora.py:232-234), with the serving kernels;
- text tower with the stacked adapter tree threaded through the blocks, on
  ``attn_impl`` ``pallas_vjp`` (the default on the card: the packed-QKV core
  kernel forward, autograd backward) or ``block_fused`` (the whole-block
  forward and backward kernels of ``ops.block_grad``); with
  ``quantize_text`` the text tower's backbone goes int8 and ``block_fused``
  becomes ``block_fused_int8``, the int8 serving numerics in bf16 (the int8
  whole-block kernels);
- symmetric InfoNCE with diagonal labels at ``logit_scale.exp()``
  (train_lora.py:241-246), ``logit_scale`` frozen;
- AdamW(lr 1e-4, weight decay 0.01) on the adapters with global-norm clip 1.0
  and a per-epoch cosine lr, computed as optax's chain computes it
  (``AdamW``);
- 90/10 random split, a random prompt per item per visit from a numpy
  ``Generator`` consumed exactly as the JAX trainer consumes it;
- best-val adapters as a reference ``.pth`` and an ``.npz``; full state
  (``train.checkpoint``) for replay-identical resume.

Every entry point takes ``device`` (default ``"cuda"``); the tests pass
``"cpu"``, where every kernel wrapper takes its plain version. Under a
``mesh`` (``parallel.create_mesh``) the device is the rank's own, and each
rank runs its rows of every global batch (``make_train_step``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from aiic_tpu_torch.adapters import ATTACH_POINTS, LoRAConfig, init_text_lora, save_lora_pth
from aiic_tpu_torch.adapters.torch_convert import lora_tree_to_pth_dict
from aiic_tpu_torch.data.dataset import build_training_prompts, load_training_data
from aiic_tpu_torch.data.preprocess import preprocess_pil
from aiic_tpu_torch.data.tokenizer import tokenize_for_model
from aiic_tpu_torch.models.clip import encode_image, encode_text, normalize_features
from aiic_tpu_torch.models.config import VIT_B_16, CLIPConfig
from aiic_tpu_torch.ops import block_grad, quant
from aiic_tpu_torch.parallel import sharding
from aiic_tpu_torch.parallel.mesh import all_gather, all_reduce, mesh_device
from aiic_tpu_torch.parallel.multihost import host_local_batch, process_local_rows

Params = Dict[str, Any]

@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``: same fields and defaults, with
    ``dtype`` a ``torch.dtype``."""

    epochs: int = 20
    batch_size: int = 8
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    rank: int = 16
    alpha: int = 32
    val_fraction: float = 0.1
    seed: int = 0
    attach: Tuple[str, ...] = ("c_fc", "c_proj", "out_proj")
    lora_dropout: float = 0.0
    dtype: Any = torch.float32
    attn_impl: str = "auto"
    remat_text: bool = True
    image_attn_impl: Any = None
    quantize_image: bool = False
    quantize_text: bool = False
    cache_image_features: bool = True
    dedup_prompts: bool = True


def contrastive_loss(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE with diagonal labels (train_lora.py:241-246), in fp32
    as JAX promotes it (the fp32 scale times the features)."""
    scale = torch.exp(logit_scale.float())
    logits = (scale * img_feats.float()) @ txt_feats.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels)
    lt = F.cross_entropy(logits.T, labels)
    return (li + lt) / 2.0


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adamw) step for step
# ---------------------------------------------------------------------------


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(clip), optax.adamw(schedule,
    weight_decay))`` on an adapter tree, operation for operation:

    - clip: the global norm sqrt(sum over leaves of sum(g*g)); when it is at
      least ``clip``, every leaf becomes ``g / norm * clip`` (no epsilon —
      ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is
      not this);
    - Adam (b1 0.9, b2 0.999, eps 1e-8): ``m = (1-b1) g + b1 m``,
      ``v = (1-b2) g^2 + b2 v``, bias corrections with the count after its
      increment, ``m_hat / (sqrt(v_hat) + eps)``;
    - decoupled weight decay ``u + wd * p`` and the step ``p + (-lr) * u``,
      lr from ``schedule(count)`` at the count before its increment.

    State: ``{"exp_avg": tree, "exp_avg_sq": tree, "step": int}``, fp32
    tensors beside the parameters."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 grad_clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.weight_decay, self.grad_clip = schedule, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, tree: Params) -> Params:
        zeros = {p: {ab: torch.zeros_like(t) for ab, t in d.items()} for p, d in tree.items()}
        return {"exp_avg": zeros,
                "exp_avg_sq": {p: {ab: t.clone() for ab, t in d.items()} for p, d in zeros.items()},
                "step": 0}

    def update(self, grads: Params, state: Params, params: Params,
               norm_sq: Optional[torch.Tensor] = None) -> Tuple[Params, Params]:
        """-> (new params, new state); neither input is modified. ``norm_sq``:
        the squared global norm where the caller holds only part of some
        leaves (a tensor-parallel step sums its shards over the mesh)."""
        keys = sorted((p, ab) for p in grads for ab in grads[p])  # optax's leaf order
        if norm_sq is None:
            norm_sq = sum(torch.sum(grads[p][ab] * grads[p][ab]) for p, ab in keys)
        norm = torch.sqrt(norm_sq)
        keep = norm < self.grad_clip  # a device flag: no host sync per step
        step = state["step"]
        count = step + 1
        f32 = dict(dtype=torch.float32, device=norm.device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** count
        bc2 = 1 - torch.tensor(self.b2, **f32) ** count
        lr = torch.tensor(-self.schedule(step), **f32)
        new_p, m_out, v_out = {}, {}, {}
        for p, ab in keys:
            g = torch.where(keep, grads[p][ab], (grads[p][ab] / norm) * self.grad_clip)
            m = (1 - self.b1) * g + self.b1 * state["exp_avg"][p][ab]
            v = (1 - self.b2) * (g * g) + self.b2 * state["exp_avg_sq"][p][ab]
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * params[p][ab]
            new_p.setdefault(p, {})[ab] = params[p][ab] + lr * u
            m_out.setdefault(p, {})[ab] = m
            v_out.setdefault(p, {})[ab] = v
        return new_p, {"exp_avg": m_out, "exp_avg_sq": v_out, "step": count}


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> AdamW:
    """AdamW + cosine annealing stepped per epoch (torch
    CosineAnnealingLR(T_max=epochs) stepped per epoch), the lr computed in
    fp32 as the JAX schedule computes it."""

    def lr_schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        angle = np.float32(np.pi) * np.float32(epoch) / np.float32(cfg.epochs)
        return float(np.float32(cfg.lr * 0.5) * (np.float32(1.0) + np.cos(angle)))

    return AdamW(lr_schedule, cfg.weight_decay, cfg.grad_clip)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def make_train_step(config: CLIPConfig, cfg: TrainConfig, optimizer: AdamW, mesh=None,
                    cached_image: bool = False, prompt_pool: Optional[np.ndarray] = None,
                    device="cuda", *, replicate_visual: bool = True,
                    replicate_text: Optional[bool] = None) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) as the JAX package's ``make_train_step``:

    ``train_step(params, lora, opt_state, batch_x, tokens, generator=None)
    -> (loss, lora, opt_state)``; ``eval_step(params, lora, batch_x, tokens)
    -> loss``. ``batch_x`` is pixels (B, H, W, 3), or with ``cached_image``
    a slice of the ``train_step.image_features`` table. With
    ``prompt_pool`` ([P, context] tokens of the run's unique prompts)
    ``tokens`` is a [B] vector of pool indices: the pool is encoded once per
    step and rows are gathered. ``generator`` feeds LoRA dropout only.

    ``train_step.text_impl`` is the resolved text path: ``"auto"`` gives
    ``"pallas_vjp"`` on the card and ``"xla"`` on the CPU; ``"block_fused"``
    falls back the same way where the kernel's preconditions fail (the full
    attach set, no dropout, quick-gelu, the JAX package's geometry gate),
    and becomes ``"block_fused_int8"`` with ``quantize_text`` where the int8
    gate admits the geometry; ``quantize_text`` on any other path raises.
    ``params`` then carries the text tower's ``attn_q``/``mlp_q``
    (``quantize_model_mlp``, as ``train_lora`` quantizes).

    ``mesh`` (``parallel.create_mesh``; the device is then the rank's): each
    rank runs the step's programs on its rows of the global batch, which it
    takes as a ``host_local_batch`` DTensor or whole. The frozen image tower
    runs per rank with replicated weights, its kernels included. On a
    kernel text path the differentiated text tower does the same with
    replicated weights and adapters; on ``"xla"`` it runs tensor-parallel
    over ``"model"`` (``parallel.sharding.TensorParallel``) on adapters
    sharded per ``lora_pspecs``. The feature rows are gathered over
    ``"data"`` and every rank takes the global contrastive loss; the adapter
    gradients are summed over ``"data"`` once. Token rows (the prompt
    pool's) are padded to the ``"data"`` multiple and sliced off before the
    loss. State trees come in whole or as DTensors (``shard_train_step``)
    and go out as DTensors.

    The mesh layout is fixed here, as the steps are explicit programs:
    ``replicate_visual=False`` runs the frozen image tower tensor-parallel
    (the plain path only); ``replicate_text`` likewise for the text tower,
    by default tensor-parallel on ``"xla"`` alone. ``train_step.layout``
    holds the two choices, ``train_step.placements(params, lora,
    opt_state)`` the states' placement trees, built once."""
    dev = torch.device(device) if mesh is None else mesh_device(mesh)
    on_card = dev.type == "cuda"
    scaling = cfg.alpha / cfg.rank
    image_impl = cfg.image_attn_impl or ("pallas" if on_card else "xla")
    image_dtype = torch.bfloat16 if cfg.quantize_image else cfg.dtype
    fallback = "pallas_vjp" if on_card else "xla"
    text_impl = fallback if cfg.attn_impl == "auto" else cfg.attn_impl
    text_remat = cfg.remat_text
    if text_impl == "block_fused":
        kernel_ok = (
            cfg.lora_dropout == 0.0
            and all(k in cfg.attach for k in ATTACH_POINTS)
            and config.gelu_type == "quick_gelu"
            and block_grad.text_block_supported(
                config.context_length, config.text.width, config.text.mlp_dim,
                config.text.heads, torch.empty((), dtype=cfg.dtype).element_size()))
        if kernel_ok:
            # the whole-block backward recomputes its forward already;
            # checkpointing it would replay the forward a third time
            text_remat = False
            if cfg.quantize_text and block_grad.text_block_int8_supported(
                    config.context_length, config.text.width, config.text.mlp_dim,
                    config.text.heads):
                text_impl = "block_fused_int8"
        else:
            text_impl = fallback
    if cfg.quantize_text and text_impl != "block_fused_int8":
        # the JAX package's refusal: silently training bf16 gradients would
        # ship adapters trained against numerics the int8 engine never runs
        raise ValueError(
            "quantize_text requires the int8 whole-block text kernel, which "
            f"was not selected (resolved attn_impl={text_impl!r}). It needs "
            "attn_impl='block_fused', the full reference attach set, "
            "lora_dropout=0, quick-gelu, and a text tower that fits "
            "the kernel's VMEM budget "
            "(ops/block_grad.text_block_int8_supported).")
    if replicate_text is None:
        replicate_text = text_impl != "xla"
    if mesh is not None and not replicate_text and text_impl != "xla":
        raise ValueError(f"the {text_impl!r} text path runs data-parallel with its kernels: "
                         "it needs replicate_text=True")
    if mesh is not None and not replicate_visual and image_impl != "xla":
        raise ValueError(f"the {image_impl!r} image path runs data-parallel with its kernels: "
                         "it needs replicate_visual=True")
    # the int8 serving composition computes in bf16; the loss keeps the
    # image features in cfg.dtype
    text_dtype = torch.bfloat16 if text_impl == "block_fused_int8" else cfg.dtype
    if prompt_pool is not None and cfg.lora_dropout > 0.0:
        raise ValueError(
            "prompt_pool (dedup_prompts) requires lora_dropout == 0: a deduplicated row "
            "would share one dropout mask across its duplicates, changing the reference "
            "per-row-dropout semantics")
    pool_tokens = None if prompt_pool is None else torch.as_tensor(prompt_pool, device=dev)

    if mesh is None:
        dp, di, dgroup, text_tp, image_tp = 1, 0, None, None, None
    else:
        dp, di, dgroup = mesh.size(0), mesh.get_local_rank("data"), mesh.get_group("data")
        text_tp = None if replicate_text else sharding.TensorParallel(mesh)
        image_tp = None if replicate_visual else sharding.TensorParallel(mesh)

    built: Dict[str, Any] = {}

    def placements(params=None, lora_tree=None, opt_state=None):
        """(params', adapters', optimizer state's) placement trees, each
        built on its first use: a run's trees keep their structure."""
        if params is not None and "params" not in built:
            built["params"] = sharding.param_pspecs(params, replicate_visual=replicate_visual,
                                                    replicate_text=replicate_text)
        if lora_tree is not None and "lora" not in built:
            built["lora"] = sharding.lora_pspecs(lora_tree, replicate=replicate_text)
        if opt_state is not None and "opt" not in built:
            built["opt"] = sharding._opt_state_pspecs(opt_state, lora_tree, built["lora"])
        return built.get("params"), built.get("lora"), built.get("opt")

    def image_local(params, pixels):
        with torch.no_grad():
            f = encode_image({"visual": params["visual"]}, pixels, config, dtype=image_dtype,
                             attn_impl=image_impl, tp=image_tp)
            return normalize_features(f).to(cfg.dtype)

    def image_features(params: Params, pixels: torch.Tensor) -> torch.Tensor:
        """The frozen-tower branch exactly as the loss sees it (under a mesh:
        the global batch's rows, each rank encoding its own)."""
        if mesh is None:
            return image_local(params, pixels)
        local = sharding.local_tree(params, placements(params)[0], mesh)
        return all_gather(image_local(local, sharding.batch_rows(pixels, dp, di)), dgroup)

    def text_features(lora_tree, params, token_rows, generator=None, rows=None):
        return normalize_features(encode_text(
            params, token_rows, config, dtype=text_dtype, attn_impl=text_impl,
            lora=lora_tree, lora_scaling=scaling,
            lora_dropout=cfg.lora_dropout if generator is not None else 0.0,
            lora_generator=generator, remat=text_remat, lora_rows=rows, tp=text_tp))

    def loss_fn(lora_tree, params, batch_x, tokens, generator=None):
        """The loss on local trees: this rank's rows encoded, every row's
        features gathered (under a mesh)."""
        x = sharding.batch_rows(batch_x, dp, di) if mesh is not None else batch_x
        img = x.to(cfg.dtype) if cached_image else image_local(params, x)
        if mesh is not None:
            img = all_gather(img, dgroup)
        if pool_tokens is not None:
            pool = pool_tokens
            if mesh is not None:
                pad = (-len(pool)) % dp
                if pad:
                    pool = torch.cat([pool, pool.new_zeros((pad,) + pool.shape[1:])])
                pool = sharding.gather_rows(text_features(lora_tree, params, pool.chunk(dp)[di]),
                                            dgroup, di)[:len(pool_tokens)]
                if isinstance(tokens, DTensor):
                    tokens = all_gather(tokens.to_local(), dgroup)
                txt = pool[tokens.long()]
            else:
                txt = text_features(lora_tree, params, pool)[tokens.long()]
        elif mesh is not None:
            rows = sharding.batch_rows(tokens, dp, di)
            txt = sharding.gather_rows(
                text_features(lora_tree, params, rows, generator,
                              (di * rows.shape[0], dp * rows.shape[0])), dgroup, di)
        else:
            txt = text_features(lora_tree, params, tokens, generator)
        return contrastive_loss(img, txt, params["logit_scale"])

    def grads_and_norm(grads, keys, lspec):
        """Adapter gradients summed over "data" (one collective), and the
        squared global norm with the model-sharded leaves' sums over
        "model"."""
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), dgroup)
        grads = [t.view_as(g) for t, g in zip(flat.split([g.numel() for g in grads]), grads)]
        sq = [torch.sum(g * g) for g in grads]
        split = [j for j, (p, ab) in enumerate(keys) if isinstance(lspec[p][ab][1], Shard)]
        if split:  # tensor-parallel adapters: each rank holds a shard of these
            summed = all_reduce(torch.stack([sq[j] for j in split]), text_tp.group)
            for j, v in zip(split, summed):
                sq[j] = v
        return grads, sum(sq[j] for j in sorted(range(len(keys)), key=lambda j: keys[j]))

    def train_step(params, lora_tree, opt_state, batch_x, tokens, generator=None):
        norm_sq = None
        if mesh is not None:
            pspec, lspec, ospec = placements(params, lora_tree, opt_state)
            params = sharding.local_tree(params, pspec, mesh)
            lora_tree = sharding.local_tree(lora_tree, lspec, mesh)
            opt_state = sharding.local_tree(opt_state, ospec, mesh)
        leaves = {p: {ab: t.detach().requires_grad_() for ab, t in d.items()}
                  for p, d in lora_tree.items()}
        loss = loss_fn(leaves, params, batch_x, tokens,
                       generator if cfg.lora_dropout > 0.0 else None)
        keys = [(p, ab) for p in leaves for ab in leaves[p]]
        grads = torch.autograd.grad(loss, [leaves[p][ab] for p, ab in keys])
        if mesh is not None:
            grads, norm_sq = grads_and_norm(grads, keys, lspec)
        tree = {}
        for (p, ab), g in zip(keys, grads):
            tree.setdefault(p, {})[ab] = g
        new_lora, opt_state = optimizer.update(tree, opt_state, lora_tree, norm_sq)
        if mesh is not None:
            new_lora = sharding.distribute_tree(new_lora, lspec, mesh)
            opt_state = sharding.distribute_tree(opt_state, ospec, mesh)
        return loss.detach(), new_lora, opt_state

    def eval_step(params, lora_tree, batch_x, tokens):
        if mesh is not None:
            pspec, lspec, _ = placements(params, lora_tree)
            params = sharding.local_tree(params, pspec, mesh)
            lora_tree = sharding.local_tree(lora_tree, lspec, mesh)
        with torch.no_grad():
            return loss_fn(lora_tree, params, batch_x, tokens)

    train_step.image_features = image_features
    train_step.mesh = mesh
    train_step.layout = {"replicate_visual": replicate_visual, "replicate_text": replicate_text}
    train_step.placements = placements
    train_step.text_impl = eval_step.text_impl = text_impl
    return train_step, eval_step


# ---------------------------------------------------------------------------
# Host-side data plumbing
# ---------------------------------------------------------------------------


class PromptedImageDataset:
    """(image, random-prompt tokens) pairs from the dataset JSON (reference
    InteriorStyleDataset, train_lora.py:121-161). Draws from the numpy
    ``Generator`` it is handed exactly as the JAX package's does, so both
    packages replay the same prompts from the same seed."""

    def __init__(self, training_data, config: CLIPConfig, image_root: str = "."):
        self.config = config
        self.items = [(item["image_path"], build_training_prompts(item))
                      for item in training_data]
        self.image_root = image_root
        self._cache: Dict[str, np.ndarray] = {}
        # the global unique-prompt pool (first-occurrence order) and each
        # item's prompt -> pool index list, for TrainConfig.dedup_prompts
        pool_index: Dict[str, int] = {}
        self.prompt_pool: list = []
        self._item_pool_ids: list = []
        for _, prompts in self.items:
            ids = []
            for p in prompts:
                if p not in pool_index:
                    pool_index[p] = len(self.prompt_pool)
                    self.prompt_pool.append(p)
                ids.append(pool_index[p])
            self._item_pool_ids.append(ids)

    def __len__(self):
        return len(self.items)

    def load_pixels(self, idx: int) -> np.ndarray:
        path, _ = self.items[idx]
        if path not in self._cache:
            from PIL import Image

            full = path if os.path.isabs(path) else os.path.join(self.image_root, path)
            try:
                img = Image.open(full).convert("RGB")
                self._cache[path] = preprocess_pil(img, self.config.image_size)
            except Exception:
                # reference fallback: a zero image (train_lora.py:156-161)
                self._cache[path] = np.zeros(
                    (self.config.image_size, self.config.image_size, 3), np.float32)
        return self._cache[path]

    def batch_tokens(self, indices, rng: np.random.Generator) -> np.ndarray:
        """One random-prompt draw per index (train_lora.py:186-188)."""
        texts = []
        for i in indices:
            prompts = self.items[i][1]
            texts.append(prompts[int(rng.integers(0, len(prompts)))])
        return tokenize_for_model(texts, self.config)

    def batch_prompt_ids(self, indices, rng: np.random.Generator) -> np.ndarray:
        """Pool index of one random-prompt draw per row: the same draws as
        ``batch_tokens``."""
        ids = []
        for i in indices:
            ids.append(self._item_pool_ids[i][int(rng.integers(0, len(self.items[i][1])))])
        return np.asarray(ids, np.int32)

    def batch(self, indices, rng: np.random.Generator):
        pixels = np.stack([self.load_pixels(i) for i in indices])
        return pixels, self.batch_tokens(indices, rng)


def precompute_image_features(image_features_fn: Callable, params: Params,
                              ds: PromptedImageDataset, batch: int,
                              place_batch: Callable) -> torch.Tensor:
    """[len(ds), embed_dim] table of the trainer's image-branch output, on
    the device, computed once per unique image path in batches of ``batch``
    (the last one padded by cycling, as the JAX package pads it): the tower is
    frozen and the preprocessing deterministic, so the table holds for the
    whole run."""
    n = len(ds)
    path_to_uid: Dict[str, int] = {}
    row_uid = np.empty(n, np.int64)
    uniq_rows = []
    for i, (path, _) in enumerate(ds.items):
        if path not in path_to_uid:
            path_to_uid[path] = len(uniq_rows)
            uniq_rows.append(i)
        row_uid[i] = path_to_uid[path]
    idx = np.arange(len(uniq_rows))
    pad = (-len(idx)) % batch
    if pad:
        idx = np.concatenate([idx, np.resize(idx, pad)])
    t0 = time.perf_counter()
    out = None
    for i in range(0, len(idx), batch):
        sl = idx[i:i + batch]
        pixels = np.stack([ds.load_pixels(uniq_rows[int(j)]) for j in sl])
        f = image_features_fn(params, place_batch(pixels))
        if out is None:
            out = torch.zeros((len(uniq_rows), f.shape[-1]), dtype=f.dtype, device=f.device)
        out[torch.as_tensor(sl, device=f.device)] = f
    precompute_image_features.last_seconds = time.perf_counter() - t0
    precompute_image_features.unique_images = len(uniq_rows)
    return out[torch.as_tensor(row_uid, device=out.device)]


def _quiet(_msg: str) -> None:
    pass


def _cpu_tree(tree: Params) -> Params:
    return {p: {ab: t.detach().cpu().clone() for ab, t in d.items()} for p, d in tree.items()}


def train_lora(json_path: str = "interior_dataset.json",
               save_path: str = "lora_models/comprehensive_lora_improved.pth", *,
               params: Optional[Params] = None, config: CLIPConfig = VIT_B_16,
               cfg: Optional[TrainConfig] = None, image_root: Optional[str] = None,
               mesh=None, resume: bool = False, log: Callable[[str], None] = print,
               device="cuda") -> Dict[str, Any]:
    """Full training run -> {best_val_loss, lora_tree (on the CPU), history}.

    ``params``: the backbone on ``device`` (fp32 tree, as
    ``models.init.load_clip_weights`` gives it); ``None`` makes a seeded
    ``init_clip_params``. ``resume=True`` continues from
    ``{save_path}.state.npz`` (adapters, optimizer, epoch, best val, the
    data-order rng and the step count), replaying the uninterrupted run.

    ``mesh``: every rank of the mesh calls this with the same arguments.
    Each draws the same data order and prompts, loads only its rows of each
    global batch (``process_local_rows``, ``host_local_batch``) and runs the
    mesh's step (``make_train_step``), train and eval split alike; the
    losses are the single-device run's. The image-feature cache is used
    where the world is one rank (each step recomputes the features above
    that); rank 0 alone logs and writes the outputs."""
    from aiic_tpu_torch.models.init import init_clip_params
    from aiic_tpu_torch.train.checkpoint import load_train_state, save_train_state

    cfg = cfg or TrainConfig()
    dev = torch.device(device) if mesh is None else mesh_device(mesh)
    world = 1 if mesh is None else dist.get_world_size()
    main_rank = mesh is None or dist.get_rank() == 0
    if not main_rank:
        log = _quiet
    if params is None:
        params = init_clip_params(config, torch.Generator(device=dev).manual_seed(cfg.seed),
                                  device=dev)
    towers = tuple(t for t, on in (("visual", cfg.quantize_image), ("text", cfg.quantize_text))
                   if on)
    if towers:
        # int8 weights on the selected towers: the frozen image tower runs
        # the serving kernels, the text tower the int8 whole-block kernels
        params = quant.quantize_model_mlp(params, attn=True, towers=towers)
    if image_root is None:
        image_root = os.path.dirname(os.path.abspath(json_path))
    ds = PromptedImageDataset(load_training_data(json_path), config, image_root=image_root)

    rng = np.random.default_rng(cfg.seed)
    order = rng.permutation(len(ds))
    n_val = max(1, int(len(ds) * cfg.val_fraction))
    val_idx, train_idx = order[:n_val], order[n_val:]
    steps_per_epoch = max(1, len(train_idx) // cfg.batch_size)

    lora_cfg = LoRAConfig(rank=cfg.rank, alpha=cfg.alpha, attach=cfg.attach)
    lora_tree = init_text_lora(torch.Generator(device=dev).manual_seed(cfg.seed), config,
                               lora_cfg, device=dev)
    optimizer = make_optimizer(cfg, steps_per_epoch)
    opt_state = optimizer.init(lora_tree)

    start_epoch, best_val, resume_step = 0, float("inf"), 0
    state_path = (save_path + ".state.npz") if save_path else None
    if resume and state_path and os.path.exists(state_path):
        lora_tree, opt_state, meta = load_train_state(state_path, lora_tree, opt_state, device=dev)
        start_epoch = int(meta["epoch"]) + 1
        best_val = float(meta["best_val_loss"])
        if "rng_state" in meta:
            rng.bit_generator.state = meta["rng_state"]
            resume_step = int(meta.get("step", 0))
        else:
            log("  (state file predates rng persistence: data order will "
                "not replay the uninterrupted run)")
        log(f"resumed from {state_path} at epoch {start_epoch} (best val {best_val:.4f})")

    # the cached table is whole on every rank: a world of one alone uses it
    use_cache = cfg.cache_image_features and world == 1
    pool = ds.prompt_pool
    use_dedup = cfg.dedup_prompts and cfg.lora_dropout == 0.0 and 0 < len(pool) <= cfg.batch_size
    pool_tokens = tokenize_for_model(pool, config) if use_dedup else None
    train_step, eval_step = make_train_step(config, cfg, optimizer, mesh=mesh,
                                            cached_image=use_cache, prompt_pool=pool_tokens,
                                            device=dev)
    if use_dedup:
        log(f"prompt dedup: {len(pool)} unique prompts encoded per step "
            f"(vs {cfg.batch_size} dense rows)")

    if mesh is None:
        def place_batch(a) -> torch.Tensor:
            return a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a)).to(dev)

        def local_rows(rows):
            return rows
    else:
        # each rank feeds only its rows of every global batch; the kernel
        # text paths replicate the text weights and adapters, "xla" splits
        # them over "model"
        train_step, eval_step, params, lora_tree, opt_state = sharding.shard_train_step(
            mesh, train_step, eval_step, params, lora_tree, opt_state)

        def place_batch(a: np.ndarray):
            return host_local_batch(mesh, a)

        def local_rows(rows):
            return process_local_rows(rows, mesh)

    feats_table = None
    if use_cache:
        feats_table = precompute_image_features(train_step.image_features, params, ds,
                                                cfg.batch_size, place_batch)
        log(f"cached {len(ds)} image features once "
            f"({precompute_image_features.unique_images} unique images, "
            f"{precompute_image_features.last_seconds:.1f}s); train steps are text-only")

    def make_batch(sl):
        """(image batch, token batch) of this rank's rows, with the global
        batch's rng draws on every path and every rank."""
        toks = local_rows(ds.batch_prompt_ids(sl, rng) if use_dedup else ds.batch_tokens(sl, rng))
        rows = local_rows(sl)
        if use_cache:
            return place_batch(feats_table[torch.as_tensor(rows, device=dev)]), place_batch(toks)
        return place_batch(np.stack([ds.load_pixels(int(i)) for i in rows])), place_batch(toks)

    def run_epoch_batches(indices):
        idx = rng.permutation(indices)
        for i in range(0, len(idx) - cfg.batch_size + 1, cfg.batch_size):
            yield make_batch(idx[i:i + cfg.batch_size])

    history = []
    best_tree = _cpu_tree(sharding.full_tree(lora_tree))
    step_n = resume_step
    for epoch in range(start_epoch, cfg.epochs):
        train_losses = []
        t0 = time.perf_counter()
        for batch_x, tokens in run_epoch_batches(train_idx):
            step_n += 1
            gen = None
            if cfg.lora_dropout > 0.0:
                gen = torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + step_n)
            loss, lora_tree, opt_state = train_step(params, lora_tree, opt_state, batch_x,
                                                    tokens, gen)
            train_losses.append(loss)  # a device scalar: read at the epoch's end
        train_losses = [float(x) for x in train_losses]
        train_seconds = time.perf_counter() - t0
        val_losses = []
        vi = val_idx
        if len(vi) > 0:
            reps = max(1, -(-cfg.batch_size // len(vi)))
            vi_padded = np.tile(vi, reps)
            for i in range(max(1, len(vi) // cfg.batch_size)):
                sl = vi_padded[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                if len(sl) < cfg.batch_size:
                    sl = vi_padded[:cfg.batch_size]
                batch_x, tokens = make_batch(sl)
                val_losses.append(eval_step(params, lora_tree, batch_x, tokens))
            val_losses = [float(x) for x in val_losses]
        avg_train = float(np.mean(train_losses)) if train_losses else float("nan")
        avg_val = float(np.mean(val_losses)) if val_losses else avg_train
        history.append({"epoch": epoch + 1, "train_loss": avg_train, "val_loss": avg_val,
                        "train_seconds": train_seconds,
                        "train_images": len(train_losses) * cfg.batch_size})
        log(f"epoch {epoch + 1}/{cfg.epochs}  train {avg_train:.4f}  val {avg_val:.4f}")

        if avg_val < best_val:
            best_val = avg_val
            best_tree = _cpu_tree(sharding.full_tree(lora_tree))
            if save_path and main_rank:
                os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
                save_lora_pth(best_tree, save_path)
                np.savez(save_path + ".npz", **lora_tree_to_pth_dict(best_tree))
                log(f"  saved best adapters (val {avg_val:.4f}) -> {save_path}")

        if state_path:
            whole = sharding.full_tree({"lora": lora_tree, "opt": opt_state})
            if main_rank:
                save_train_state(state_path, whole["lora"], whole["opt"], epoch=epoch,
                                 best_val_loss=best_val, seed=cfg.seed,
                                 rng_state=rng.bit_generator.state, step=step_n)

    return {"best_val_loss": best_val, "lora_tree": best_tree, "history": history}
