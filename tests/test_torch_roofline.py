"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's (``repro.analysis.roofline``).

The reference's ``tests/test_roofline.py`` cases run through both
packages. The port holds no TPU figure: its cases pass the reference's TPU
v5e row as ``hw=``, and that row lives in this file only. The parser is
the reference's text function, so its results are held bit for bit; the
terms are the same arithmetic on the same numbers, so they are held
exactly too.
"""
import os
import re

import pytest
import torch

import repro.analysis.roofline as R
import repro_torch.analysis.roofline as P

# the reference's hardware row (src/repro/analysis/roofline.py), as the
# port's mapping; used here only, to hold the arithmetic to the reference's
TPU_V5E = {"peak_flops": R.HW["peak_flops"], "hbm_bw": R.HW["hbm_bw"],
           "link_bw": R.HW["ici_bw"]}
H100 = "NVIDIA H100 80GB HBM3"

HLO = """
ENTRY %main {
  %ag = f32[3072,192]{1,0} all-gather(%p0), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  %ar = bf16[1024,512]{1,0} all-reduce(%x), channel_id=2, replica_groups=[16,16]<=[256]
  %rs = f32[64,64]{1,0} reduce-scatter(%y), channel_id=3, replica_groups=[16,16]<=[256], dimensions={0}
  %cp = f32[128]{0} collective-permute(%z), channel_id=4
  %a2a = bf16[32,32]{1,0} all-to-all(%w), channel_id=5
  %ard = f32[8,8]{1,0} all-reduce-done(%ar2)
  %not-a-collective = f32[9999]{0} add(%a, %b)
}
"""
# async pairs, tuple results, a group-less reduce-scatter, an unknown type
HLO_MORE = """
  %s = f32[100]{0} all-reduce-start(%a)
  %d = f32[100]{0} all-reduce-done(%s)
  %t = (bf16[4,8]{1,0}, f32[16]{0}) all-gather-start(%u, %v), dimensions={0}
  %td = (bf16[4,8]{1,0}, f32[16]{0}) all-gather-done(%t)
  %r = s32[7,3]{1,0} reduce-scatter(%q), dimensions={0}
  %o = token[] collective-permute(%k)
  %p = pred[5]{0} all-to-all(%m)
"""

PKGS = ["reference", "port"]


def _mod(pkg):
    return R if pkg == "reference" else P


def _terms(pkg, cost, hlo, **kw):
    if pkg == "reference":
        return R.roofline_terms(cost, hlo, **kw)
    return P.roofline_terms(cost, hlo, hw=TPU_V5E, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_collective_parser_kinds_and_sizes(pkg):
    out = _mod(pkg).collective_bytes(HLO)
    assert out["all-gather"] == 3072 * 192 * 4          # 1x result
    assert out["all-reduce"] == 2 * 1024 * 512 * 2      # 2x ring, bf16
    assert out["reduce-scatter"] == 64 * 64 * 4 * 16    # result x group
    assert out["collective-permute"] == 128 * 4
    assert out["all-to-all"] == 32 * 32 * 2
    # -done halves are not double counted
    assert sum(out.values()) < 10_000_000


@pytest.mark.parametrize("pkg", PKGS)
def test_done_ops_skipped(pkg):
    txt = "%x = f32[100]{0} all-reduce-start(%a)\n%y = f32[100]{0} all-reduce-done(%x)"
    out = _mod(pkg).collective_bytes(txt)
    assert out["all-reduce"] == 2 * 100 * 4  # start counted once


@pytest.mark.parametrize("pkg", PKGS)
def test_roofline_terms_and_bottleneck(pkg):
    cost = {"flops": 197e12, "bytes accessed": 819e9 / 2}
    rl = _terms(pkg, cost, HLO, chips=256, model_flops=197e12 * 256 * 0.5)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.bottleneck == "compute"
    assert rl.useful_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_model_flops(pkg):
    assert _mod(pkg).model_flops_estimate(1e9, 1e6, "train") == 6e15
    assert _mod(pkg).model_flops_estimate(1e9, 1e6, "infer") == 2e15


@pytest.mark.parametrize("text", [HLO, HLO_MORE, HLO + HLO_MORE, ""])
def test_collective_bytes_bit_for_bit(text):
    assert P.collective_bytes(text) == R.collective_bytes(text)


@pytest.mark.parametrize("cost,chips,mf", [
    ({"flops": 197e12, "bytes accessed": 819e9 / 2}, 256, 1e16),
    ({"flops": 1e9, "bytes accessed": 1e12}, 1, 2e9),      # memory-bound
    ({"flops": 1.0, "bytes accessed": 1.0}, 512, None),    # collective-bound
    ({}, 4, 0.0),
])
def test_rows_equal_the_reference(cost, chips, mf):
    """Every key of ``to_row()``, the same values, with the reference's
    hardware passed to the port."""
    got = P.roofline_terms(cost, HLO, chips=chips, model_flops=mf,
                           hw=TPU_V5E).to_row()
    want = R.roofline_terms(cost, HLO, chips=chips, model_flops=mf).to_row()
    assert got == want


def test_h100_row_by_name():
    """The H100 row: bf16 989.4 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s."""
    cost = {"flops": 989.4e12, "bytes accessed": 3.35e12 * 2}
    rl = P.roofline_terms(cost, "", chips=1, model_flops=989.4e12 / 2,
                          hw=H100)
    assert rl.compute_s == pytest.approx(1.0, rel=1e-15)
    assert rl.memory_s == pytest.approx(2.0, rel=1e-15)
    assert rl.collective_s == 0.0 and rl.coll_breakdown == {}
    assert rl.bottleneck == "memory"
    assert rl.useful_ratio == pytest.approx(0.5, rel=1e-15)
    rl = P.roofline_terms({"flops": 1.0}, HLO, chips=1, hw=H100)
    assert rl.collective_s == pytest.approx(
        sum(R.collective_bytes(HLO).values()) / 450e9, rel=1e-15)
    assert list(P.HARDWARE) == [H100]


def test_hw_for_raises_on_the_cpu():
    with pytest.raises(ValueError, match="no card"):
        P.hw_for("cpu")
    with pytest.raises(ValueError):
        P.hw_for(torch.device("meta"))


def test_hw_for_without_a_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.hw_for("cuda")
    with pytest.raises(RuntimeError):
        P.roofline_terms({"flops": 1.0}, "", chips=1)


def test_hw_for_reads_the_card_and_refuses_an_unknown_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    row = P.hw_for("cuda:0")
    assert row == {"name": H100, **P.HARDWARE[H100]}
    assert P.hw_row(None) == row
    # another card never falls back to the H100 row
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        P.hw_for("cuda")
    with pytest.raises(KeyError):
        P.roofline_terms({"flops": 1.0}, "", chips=1)


def test_unknown_row_name_raises():
    with pytest.raises(KeyError, match="TPU v5e"):
        P.hw_row("TPU v5e")


def test_the_port_holds_no_tpu_figure():
    """No TPU rate or name in the port's package: its analysis and launch
    code carry the card's figures only."""
    root = os.path.dirname(P.__file__)
    for sub in ("analysis", "launch"):
        d = os.path.join(os.path.dirname(root), sub)
        for name in os.listdir(d):
            if name.endswith(".py"):
                text = open(os.path.join(d, name)).read()
                for figure in ("197e12", "819e9", "50e9", "v5e", "ici_bw"):
                    assert not re.search(rf"(?<![\d.]){figure}", text), \
                        (name, figure)
