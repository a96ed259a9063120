"""The comparison that decides ``correct``: the program's answers against the
plain reference (``h100_bench.reference.clip_ref``), worked out on the same
inputs after the program's state is freed.

Numbers compared (each against its configuration's limit):

- ``prob_gap``: over the sampled answers, the widest gap in probability
  between what the program answered and what the reference gives for the
  same answer: the interior and non-interior masses, the detector's top
  prompt (how far the reference's probability of the program's pick lies
  below the reference's best, and the program's confidence against it), and
  for every category each of the program's top-k attributes (its score
  against the reference's, and how far it lies below the reference's
  attribute of the same rank).
- ``logit_err``: the same answers in logit units (100 x cosine, the scale the
  heads apply), where an error does not saturate with the margin: the
  detector's log-odds log(interior mass / non-interior mass), how many
  logits the program's detector pick and each of its top-k attributes lie
  below the reference's of the same rank, and the log-ratios of each top-k
  score to the first one. Probabilities under 1e-30 (rounded away in
  float32) are left out.
- ``kl``: per answer, the largest Kullback-Leibler divergence KL(reference ||
  program) over the distributions the answer carries: the detector's
  interior / non-interior split and each category's attribute distribution
  (whole where the category has no more attributes than the top-k holds,
  else the top-k and the rest as one). Quadratic in small logit errors, so
  it reads how far the answer moves, not how far a probability that rounds
  to nothing moves.
- ``feat_err``: 1 - cosine of the program's image features against the
  reference's, the worst sampled answer (offline: the engine's features of
  the answer's row; served: the features that reached the request with its
  answer, judged against the reference on the request's own crop).
- ``loss_gap``: the worst of the checked training steps' relative loss gaps.
- ``grad_gap``: the first step's gradient as the optimizer holds it, by the
  worst leaf: |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median
  leaf's ‖g_ref‖.
- ``change_gap``: the same of each leaf's change over the checked steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both leaf numbers: under Adam they move by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100_bench import weights as inputs
from h100_bench.reference import clip_ref


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def reference_answers(cfg: dict, seed: int, crops: np.ndarray, device,
                      prec: str = "fp32") -> Dict[str, torch.Tensor]:
    """The reference's features and probabilities of the crops, from the
    weights made again from the seed."""
    clip_ref.no_tf32()
    w = inputs.make_weights(cfg, seed, device)
    heads = clip_ref.Heads(w, cfg, cfg["vocabulary"], device, prec)
    out = clip_ref.classify(w, _t(crops, device), cfg, heads, prec)
    out["cats"] = heads.cats
    return out


def as_program(ref: Dict[str, torch.Tensor], k: int = 5) -> Dict[str, np.ndarray]:
    """Reference answers in the program's output form (the control that puts
    the reference, in a lower precision, in the program's place)."""
    det = ref["det"]
    cats = ref["cats"]
    width = min(k, max(len(v) for v in cats.values()))
    vals = torch.zeros(det.shape[0], len(cats), width, device=det.device)
    idx = torch.zeros(det.shape[0], len(cats), width, dtype=torch.long, device=det.device)
    for ci, c in enumerate(cats):
        kk = min(width, ref[c].shape[1])
        v, i = torch.topk(ref[c], kk, dim=-1)
        vals[:, ci, :kk], idx[:, ci, :kk] = v, i
    top_conf, top_idx = det.max(dim=-1)
    out = {"top_conf": top_conf, "top_idx": top_idx,
           "interior_mass": det[:, :clip_ref.INTERIOR_COUNT].sum(-1),
           "non_interior_mass": det[:, clip_ref.INTERIOR_COUNT:].sum(-1),
           "topk_vals": vals, "topk_idx": idx, "features": ref["features"]}
    return {k2: v.cpu().numpy() for k2, v in out.items()}


TINY = 1e-30


def _lg(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double().clamp_min(TINY))


def _valid(*xs: torch.Tensor) -> torch.Tensor:
    ok = torch.ones_like(xs[0], dtype=torch.bool)
    for x in xs:
        ok &= x > TINY
    return ok


def _logit_rows(ref, prog, dev) -> torch.Tensor:
    """Per answer, the worst logit-unit gap (see the module's docstring)."""
    det = ref["det"].double()
    n = det.shape[0]
    ar = torch.arange(n, device=dev)
    top_idx = _t(prog["top_idx"], dev).long()
    mass_p = _t(prog["interior_mass"], dev).double()
    non_p = _t(prog["non_interior_mass"], dev).double()
    mass_r = det[:, :clip_ref.INTERIOR_COUNT].sum(-1)
    non_r = det[:, clip_ref.INTERIOR_COUNT:].sum(-1)
    zero = torch.zeros(n, dtype=torch.float64, device=dev)
    ok = _valid(mass_p, non_p, mass_r, non_r)
    gaps = [torch.where(ok, ((_lg(mass_p) - _lg(non_p)) - (_lg(mass_r) - _lg(non_r))).abs(), zero),
            _lg(det.max(-1).values) - _lg(det[ar, top_idx])]
    for ci, c in enumerate(ref["cats"]):
        p = ref[c].double()
        k = min(prog["topk_idx"].shape[-1], p.shape[1])
        idx = _t(prog["topk_idx"][:, ci, :k], dev).long()
        vals = _t(prog["topk_vals"][:, ci, :k], dev).double()
        bad = ((idx < 0) | (idx >= p.shape[1])).any(-1)
        pi = p.gather(1, idx.clamp(0, p.shape[1] - 1))
        best = torch.sort(p, dim=-1, descending=True).values[:, :k]
        ok = _valid(vals, pi)
        rel = ((_lg(vals) - _lg(vals[:, :1])) - (_lg(pi) - _lg(pi[:, :1]))).abs()
        rel = torch.where(ok & ok[:, :1], rel, torch.zeros_like(rel))
        gaps += [rel.amax(-1), (_lg(best) - _lg(pi)).amax(-1),
                 torch.where(bad, torch.full_like(zero, float("inf")), zero)]
    return torch.stack(gaps).amax(0)


def _kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over the last axis, float64; q's zeros where p has mass
    read as TINY."""
    p, q = p.double(), q.double().clamp_min(TINY)
    return torch.where(p > 0, p * (torch.log(p.clamp_min(TINY)) - torch.log(q)),
                       torch.zeros_like(p)).sum(-1)


def _split(p_in: torch.Tensor, p_out: torch.Tensor) -> torch.Tensor:
    total = p_in + p_out
    return torch.stack([p_in / total, p_out / total], -1)


def _with_rest(p: torch.Tensor) -> torch.Tensor:
    """Top-k probabilities and the rest (1 - their sum) as one more entry."""
    return torch.cat([p, (1.0 - p.sum(-1, keepdim=True)).clamp_min(0.0)], -1)


def _kl_rows(ref, prog, dev) -> torch.Tensor:
    det = ref["det"].double()
    mass_r = det[:, :clip_ref.INTERIOR_COUNT].sum(-1)
    non_r = det[:, clip_ref.INTERIOR_COUNT:].sum(-1)
    gaps = [_kl(_split(mass_r, non_r), _split(_t(prog["interior_mass"], dev).double(),
                                               _t(prog["non_interior_mass"], dev).double()))]
    for ci, c in enumerate(ref["cats"]):
        p = ref[c].double()
        k = min(prog["topk_idx"].shape[-1], p.shape[1])
        idx = _t(prog["topk_idx"][:, ci, :k], dev).long()
        if ((idx < 0) | (idx >= p.shape[1])).any():
            return torch.full((p.shape[0],), float("inf"), dtype=torch.float64, device=dev)
        vals = _t(prog["topk_vals"][:, ci, :k], dev).double()
        gaps.append(_kl(_with_rest(p.gather(1, idx)), _with_rest(vals)))
    return torch.stack(gaps).amax(0)


def offline_numbers(ref: Dict[str, torch.Tensor], prog: Dict[str, np.ndarray]) -> Dict[str, float]:
    dev = ref["det"].device
    det = ref["det"]
    n = det.shape[0]
    ar = torch.arange(n, device=dev)
    top_idx = _t(prog["top_idx"], dev).long()
    gaps = [(_t(prog["interior_mass"], dev) - det[:, :clip_ref.INTERIOR_COUNT].sum(-1)).abs(),
            (_t(prog["non_interior_mass"], dev) - det[:, clip_ref.INTERIOR_COUNT:].sum(-1)).abs(),
            det.max(-1).values - det[ar, top_idx],
            (_t(prog["top_conf"], dev) - det[ar, top_idx]).abs()]
    for ci, c in enumerate(ref["cats"]):
        p = ref[c]
        k = min(prog["topk_idx"].shape[-1], p.shape[1])
        idx = _t(prog["topk_idx"][:, ci, :k], dev).long()
        vals = _t(prog["topk_vals"][:, ci, :k], dev).float()
        bad = (idx < 0) | (idx >= p.shape[1])  # no attribute of this category: wrong
        pi = torch.where(bad, torch.full_like(vals, -1.0), p.gather(1, idx.clamp(0, p.shape[1] - 1)))
        best = torch.sort(p, dim=-1, descending=True).values[:, :k]
        gaps += [(vals - pi).abs().amax(-1), (best - pi).amax(-1)]
    rows = torch.stack(gaps).amax(0)
    logit = _logit_rows(ref, prog, dev)
    kl = _kl_rows(ref, prog, dev)
    feat = _feat_err(ref["features"], prog["features"])
    return {"prob_gap": float(rows.max()), "logit_err": float(logit.max()),
            "kl": float(kl.max()), **_stats("kl", kl),
            "feat_err": float(feat.max()), **_stats("prob", rows), **_stats("logit", logit),
            **_stats("feat", feat), **_between(ref["features"])}


def _feat_err(ref_f: torch.Tensor, prog_f) -> torch.Tensor:
    f = _t(prog_f, ref_f.device).float()
    return 1.0 - (f * ref_f).sum(-1) / (f.norm(dim=-1) * ref_f.norm(dim=-1))


def _between(ref_f: torch.Tensor) -> Dict[str, float]:
    """How far apart the reference puts the features of two different crops
    (1 - cosine of neighbouring sampled answers): an answer handed to the
    wrong request reads at least this."""
    d = 1.0 - (ref_f[1:] * ref_f[:-1]).sum(-1) / (ref_f[1:].norm(dim=-1) * ref_f[:-1].norm(dim=-1))
    return {"_between_min": float(d.min()), "_between_p50": float(d.median())} if len(d) else {}


def _stats(name: str, rows: torch.Tensor) -> Dict[str, float]:
    """Statistics of the per-answer numbers beside the compared worst
    (uncompared: the names start with an underscore)."""
    q = torch.quantile(rows.double(), torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                                    device=rows.device))
    return {f"_{name}_p50": float(q[0]), f"_{name}_p90": float(q[1]),
            f"_{name}_p99": float(q[2]), f"_{name}_mean": float(rows.double().mean())}


def feature_numbers(ref: Dict[str, torch.Tensor], features) -> Dict[str, float]:
    """``feat_err`` of the features each served request received with its
    answer, and the statistics beside it."""
    feat = _feat_err(ref["features"], features)
    return {"feat_err": float(feat.max()), **_stats("feat", feat), **_between(ref["features"])}


def train_numbers(cfg: dict, train: dict, seed: int, device, crops: torch.Tensor,
                  tokens: torch.Tensor, rows: List[torch.Tensor], losses: List[float],
                  grads: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """The reference follows the checked steps from the same inputs: the
    weights and adapters made again from the seed, the image features worked
    out by its own tower from the crops."""
    clip_ref.no_tf32()
    w = inputs.make_weights(cfg, seed, device)
    lora = inputs.make_lora(cfg, train["rank"], seed, device)
    before = {f"{p}/{ab}": v.float() for p, d in lora.items() for ab, v in d.items()}
    batches = []
    with torch.no_grad():
        for r in rows:
            img = torch.cat([clip_ref.normalize(clip_ref.encode_image(w, crops[r[i:i + 64]], cfg))
                             for i in range(0, len(r), 64)])
            batches.append((img, tokens[r]))
    ref_losses, ref_grads, ref_after = clip_ref.lora_train(
        w, lora, batches, cfg, train["alpha"] / train["rank"], train["lr"],
        train["weight_decay"], train["grad_clip"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gn = {k: float(v.norm()) for k, v in ref_grads.items()}
    med = float(np.median(list(gn.values())))
    kept = [k for k in gn if gn[k] >= 1e-3 * med]
    grad_gap = max(abs(float(grads[k].float().norm()) - gn[k]) / max(gn[k], med) for k in kept)
    dn = {k: float((ref_after[k] - before[k]).norm()) for k in kept}
    dmed = float(np.median(list(dn.values())))
    change_gap = max(abs(float((after[k].float() - before[k]).norm()) - dn[k]) / max(dn[k], dmed)
                     for k in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
