"""The yardstick's operation and byte counts against figures worked by hand
from the published shapes."""

from __future__ import annotations

import json

import pytest

from h100_bench import counts
from h100_bench.tests import tiny


def _cfg(name):
    return json.loads((tiny.ROOT / f"h100_bench/configs/{name}.json").read_text())


B16, L14 = _cfg("clip-vit-b16-bf16"), _cfg("clip-vit-l14-int8")


def test_b16_image_operations():
    # S = 197, W = 768: embed 2·196·768·768; each of 11 full blocks QKV
    # 2·S·W·3W + core 4·S²·W + out 2·S·W² + MLP 2·2·S·W·4W; the CLS-row
    # block K/V 2·S·W·2W, its q, out, MLP on one row, core 4·S·W; the
    # projection 2·W·512 and the heads 2·512·52
    p = counts.image_call(B16, B16["engine"], 1)
    assert sum(x.ops for x in p) == 231_211_008 + 11 * 2_907_909_120 + 478_022_656
    assert sum(x.ops for x in p) == 32_696_233_984
    stage = [x for x in p if x.where == "stage"]
    assert len(stage) == 22 and all(x.prec == "bf16" for x in stage)
    assert sum(x.ops for x in stage) == 11 * (2 * 197 * 768 * 2304 + 2 * 197 * 768 * 768)
    core = [x for x in p if x.where == "attn_core"]
    assert len(core) == 11 and core[0].ops == 4 * 197 * 197 * 768
    assert core[0].bytes == 4 * 197 * 768 * 2
    # the core is bound by its bytes: 1.21 MB at 3.35 TB/s against 119 MFLOP
    assert core[0].least_s == pytest.approx(4 * 197 * 768 * 2 / 3.35e12)


def test_l14_int8_image_operations():
    p = counts.image_call(L14, L14["engine"], 1)
    assert sum(x.ops for x in p) == 156_387_424_256
    int8 = sum(x.ops for x in p if x.prec == "int8")
    # QKV and both MLP products of 23 blocks run in int8
    assert int8 == 23 * 2 * 257 * 1024 * (3 * 1024 + 4096 * 2)
    fp32 = [x for x in p if x.prec == "fp32"]
    assert fp32[0].ops == 2 * 256 * 588 * 1024  # the folded embed, in float32 slices
    assert len([x for x in p if x.where == "stage"]) == 23 * 4


def test_batch_scales_operations_not_weight_bytes():
    one = counts.image_call(B16, B16["engine"], 1)
    many = counts.image_call(B16, B16["engine"], 512)
    assert sum(x.ops for x in many) == 512 * sum(x.ops for x in one)
    qkv1, qkv512 = one[1], many[1]
    assert qkv512.bytes < 512 * qkv1.bytes  # the weight is read once a call


def test_train_step_operations():
    tr = B16["train"]
    p = counts.train_step(B16, tr, 256)
    rows, w = 256 * 77, 512
    fwd = [x for x in p if x.where == "stage"][:4]
    assert sum(x.ops for x in fwd) == 24 * rows * w * w
    assert len([x for x in p if x.where in ("stage", "recompute", "unneeded")]) == 12 * 11
    assert sum(x.ops for x in p if x.where == "recompute") == 12 * 16 * rows * w * w
    model = sum(x.ops for x in p if x.where not in ("recompute", "unneeded"))
    # forward 24·R·W² and backward's activation gradients 24·R·W² a block, less
    # the first block's input product 6·R·W²; the causal core 4·B·S(S+1)/2·W
    # forward and twice that backward (not in the first block); rank-16 LoRA
    core = 4 * 256 * 77 * 78 / 2 * w
    lora = sum(6 * rows * 16 * (a + b) for a, b in ((w, w), (w, 2048), (2048, w)))
    assert model == pytest.approx(12 * 48 * rows * w * w - 6 * rows * w * w + 12 * core
                                  + 11 * 2 * core + 12 * lora + 2 * 256 * w * 512, rel=1e-12)


def test_peaks():
    assert counts.PEAK == {"bf16": 989.4e12, "int8": 1978.9e12, "fp32": 66.9e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12
