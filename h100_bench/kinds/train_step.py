"""``train_step``: the LoRA step of ``train.trainer.make_train_step`` on
cached image features and dense token rows, ``in_flight`` steps queued on
the device. Set-up drives the same step object through its first
``checked_steps`` steps, which the reference follows; the window runs it on
from there and ends at the first synced step at or after its seconds."""

from __future__ import annotations

import collections
import time
from typing import Any, Dict

from h100_bench import check
from h100_bench import generator as g
from h100_bench import weights as inputs


class Runner:
    def __init__(self, ctx: g.Context):
        self.ctx = ctx
        self.t = ctx.traffic

    def setup(self) -> None:
        import torch

        from aiic_tpu_torch.ops import quant
        from aiic_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

        ctx, t, tr = self.ctx, self.t, self.ctx.train
        dev, cfg = ctx.device, ctx.cfg
        self.batch = t["batch"]
        tc = TrainConfig(epochs=1, batch_size=self.batch, lr=tr["lr"],
                         weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"],
                         rank=tr["rank"], alpha=tr["alpha"], dtype=g.torch_dtype(tr["dtype"]),
                         attn_impl=tr["attn_impl"], quantize_text=tr.get("quantize_text", False))
        t_engine = time.perf_counter()
        params = inputs.make_weights(cfg, ctx.seed, dev)
        if tc.quantize_text:
            params = quant.quantize_model_mlp(params, attn=True, towers=("text",))
        self.params = params
        # one epoch longer than any run: the schedule's learning rate stays lr
        optimizer = make_optimizer(tc, steps_per_epoch=1 << 30)
        self.step_fn, _ = make_train_step(g.clip_config(cfg), tc, optimizer, cached_image=True,
                                          device=dev)
        pool = t["pool"]
        crops = inputs.make_crops(pool, cfg["image_size"], ctx.seed, dev, host=False)
        self.crops = crops
        feats = []
        mean = torch.tensor([0.48145466, 0.4578275, 0.40821073], device=dev) * 255.0
        std = torch.tensor([0.26862954, 0.26130258, 0.27577711], device=dev) * 255.0
        with torch.no_grad():
            for i in range(0, pool, self.batch):
                px = (crops[i:i + self.batch].float() - mean) / std
                feats.append(self.step_fn.image_features(params, px))
        self.features = torch.cat(feats)
        self.tokens = inputs.make_token_rows(pool, cfg, ctx.seed, dev)
        self.order = torch.from_numpy(g.pool_rows(ctx, pool)).to(dev)
        ctx.spans.records.append(("setup.engine", t_engine, time.perf_counter()))
        self.lora = inputs.make_lora(cfg, tr["rank"], ctx.seed, dev)
        self.opt = optimizer.init(self.lora)
        self.step = 0
        self.losses = []
        n_check = t["checked_steps"]
        t_warm = time.perf_counter()
        for i in range(max(n_check, t.get("warm_steps", n_check))):
            self._run_step()
            if i == 0:
                self.first_m = {p: {ab: v.clone() for ab, v in d.items()}
                                for p, d in self.opt["exp_avg"].items()}
            if i == n_check - 1:
                self.lora_checked = {p: {ab: v.clone() for ab, v in d.items()}
                                     for p, d in self.lora.items()}
        g.sync(dev)
        ctx.spans.records.append(("setup.warmup", t_warm, time.perf_counter()))

    def _rows(self, i: int):
        n = len(self.order)
        start = (i * self.batch) % n
        return self.order[start:start + self.batch]

    def _run_step(self) -> None:
        rows = self._rows(self.step)
        with self.ctx.spans("train.step"):
            loss, self.lora, self.opt = self.step_fn(self.params, self.lora, self.opt,
                                                     self.features[rows], self.tokens[rows])
        self.losses.append(loss)
        self.step += 1

    def window(self, seconds: float, marker) -> Dict[str, Any]:
        import torch

        dev = self.ctx.device
        marker.start()
        first = self.step
        events = collections.deque()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            if len(events) >= self.t["in_flight"]:
                ev = events.popleft()
                if ev is not None:
                    ev.synchronize()
            self._run_step()
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
            events.append(ev)
        g.sync(dev)
        t_end = time.perf_counter()
        marker.end()
        steps = self.step - first
        losses = torch.stack(self.losses[first:]).float().cpu()
        failed = int((~torch.isfinite(losses)).sum())
        return {"window_s": t_end - t0, "attempted": steps, "failed": failed,
                "e2e": {"train_images_per_s": steps * self.batch / (t_end - t0)},
                "counters": {}, "traced_calls": [self.batch] * steps,
                "images": steps * self.batch, "steps": steps}

    def finish(self) -> None:
        pass

    def compare(self, control) -> Dict[str, float]:
        """The reference follows the checked steps: the rows of those steps,
        the program's losses, its first gradient as the optimizer holds it
        (exp_avg / (1 - b1) after one step) and its adapters after the
        checked steps. The control here is the program's own lower-precision
        path (``Context.train``), not the reference."""
        ctx = self.ctx
        n = self.t["checked_steps"]
        rows = [self._rows(i) for i in range(n)]
        losses = [float(v) for v in self.losses[:n]]
        grads = {f"{p}/{ab}": v / (1 - 0.9) for p, d in self.first_m.items()
                 for ab, v in d.items()}
        after = {f"{p}/{ab}": v for p, d in self.lora_checked.items() for ab, v in d.items()}
        del self.step_fn, self.params, self.features, self.opt, self.lora
        g.release(ctx.device)
        return check.train_numbers(ctx.cfg, ctx.train, ctx.seed, ctx.device, self.crops,
                                   self.tokens, rows, losses, grads, after)
