"""The port's cost models and cell inputs against the JAX package's, on the
CPU: ``analysis/roofline.py`` (the suffix cost model calibrated from a
bench history, the analytic cell roofline) and ``configs/base.py``'s
``input_specs`` / ``make_inputs``.

Everything here is host arithmetic, so the port's values must equal the
reference's exactly: ``measured`` points, speedups and decisions, FLOP and
byte counts bit for bit, tokens equal and embeddings bit-equal.  The
history files are written to ``tmp_path`` and read by both packages.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_helpers import reference

ARCHS = ["zamba2_2p7b", "stablelm_1p6b", "mistral_nemo_12b", "qwen3_32b",
         "gemma3_27b", "mixtral_8x22b", "deepseek_moe_16b", "rwkv6_3b",
         "paligemma_3b", "musicgen_large"]
MODES = ("train", "prefill", "decode")


def _rl():
    from repro_torch.analysis import roofline
    return roofline


# ------------------------------------------------------- bench history


def _hist_entry(chunk=8, site="deep.site", frac=0.75, sp=4.0,
                mode="suffix", **cfg):
    """The reference's test fixture: one per-depth row."""
    return {"config": {"chunk_size": chunk, **cfg},
            "per_site_depth": {"deep": {
                "site": site, "prefix_fraction": frac,
                "speedup_suffix_vs_batched": sp, "mode": mode}}}


def _family_entry(model, backend, site, frac, sp, chunk=8,
                  dtype="float32"):
    """A line as ``examples/torch_family_bcd_sweep.py`` appends it after
    its mid-scan timing."""
    return {"utc": "2026-01-01T00:00:00Z", "git": None,
            "config": {"model": model, "dtype": dtype, "chunk_size": chunk,
                       "eval_batch": 4,
                       "n_devices": 1, "backend": backend,
                       "source": "torch_family_bcd_sweep"},
            "per_site_depth": {"midscan": {
                "site": site, "prefix_fraction": frac, "mode": "suffix",
                "batched_cands_per_s": 10.0, "suffix_cands_per_s": 10.0 * sp,
                "speedup_suffix_vs_batched": sp}},
            "speedup_suffix_vs_batched_midscan": sp}


def _write(path, entries, junk=True):
    with open(path, "w") as fh:
        if junk:
            fh.write("not json at all\n\n[1, 2, 3]\n\"a string\"\n")
            # a legacy line: summary keys only, no per_site_depth
            fh.write(json.dumps({"config": {"chunk_size": 8},
                                 "speedup_suffix_vs_batched": 4.0}) + "\n")
            fh.write(json.dumps({"config": {"chunk_size": 8},
                                 "per_site_depth": [1, 2]}) + "\n")
        for e in entries:
            fh.write(json.dumps(e) + "\n")
        if junk:
            fh.write('{"truncated": ')            # a torn last line


REFERENCE_HISTORY = [
    _hist_entry(sp=4.0, model="r18-mini"),
    _hist_entry(sp=2.0, model="r18-mini"),          # EWMA -> 3.0
    _hist_entry(sp=100.0, model="other"),           # filtered out
    _hist_entry(sp=100.0, mode="fallback"),         # not a measurement
    _hist_entry(site="shallow", frac=0.2, sp=0.9, chunk=0, model="r18-mini"),
    _hist_entry(site="shallow", frac=0.2, sp=1.3, chunk=4, model="r18-mini"),
    _hist_entry(site="mid", frac=0.5, sp=1.7, chunk=0, model="r18-mini"),
    {"config": {"chunk_size": 8, "model": "r18-mini"},
     "per_site_depth": {"bad": {"site": "x", "mode": "suffix"},
                        "worse": {"site": "y", "mode": "suffix",
                                  "prefix_fraction": "deep",
                                  "speedup_suffix_vs_batched": 2.0},
                        "none": None}},
    {"config": None, "per_site_depth": {"d": {
        "site": "deep.site", "prefix_fraction": 0.75, "mode": "suffix",
        "speedup_suffix_vs_batched": 5.0}}},
]


@pytest.mark.parametrize("fingerprint", [
    None, {"model": "r18-mini"}, {"model": "r18-mini", "n_devices": 1},
    {"model": "other"}, {"model": "absent"}])
@pytest.mark.parametrize("alpha", [0.5, 0.25, 1.0])
def test_calibrated_matches_reference_on_its_fixtures(tmp_path, fingerprint,
                                                      alpha):
    """Junk, non-dict and legacy lines skipped, the fingerprint applied on
    the keys an entry carries, fallback rows ignored, the EWMA at
    ``alpha``, a chunk of 0 taking the site's previous one: ``measured``
    equal to the reference's, float for float."""
    ref = reference()
    path = str(tmp_path / "h.jsonl")
    _write(path, REFERENCE_HISTORY)
    got = _rl().SuffixCostModel.calibrated(path, fingerprint=fingerprint,
                                           alpha=alpha, min_speedup=1.2)
    want = ref.roofline.SuffixCostModel.calibrated(
        path, fingerprint=fingerprint, alpha=alpha, min_speedup=1.2)
    assert got.measured == want.measured
    assert got.min_speedup == want.min_speedup == 1.2
    if fingerprint == {"model": "r18-mini"} and alpha == 0.5:
        # the reference's own EWMA (4, 2 -> 3), then the entry without a
        # config (no key to refuse it: 3, 5 -> 4), and the two chunk rules
        assert got.measured == ((0.2, 1.1, 4), (0.5, 1.7, 1),
                                (0.75, 4.0, 8))


def test_iter_bench_history_yields_the_references_entries(tmp_path):
    ref = reference()
    path = str(tmp_path / "h.jsonl")
    _write(path, REFERENCE_HISTORY)
    got = list(_rl()._iter_bench_history(path))
    assert got == list(ref.roofline._iter_bench_history(path))
    assert len(got) == 2 + len(REFERENCE_HISTORY)   # the legacy lines too
    assert list(_rl()._iter_bench_history(str(tmp_path / "nope"))) == []


def test_calibrated_reads_the_family_sweeps_lines(tmp_path):
    """Lines in the port's own format, two cards, two dtypes and three
    models: the fingerprint ``{"model", "dtype", "backend"}`` keeps each
    family's points of one dtype on one card, as the reference's
    calibration does."""
    ref = reference()
    h100, other = "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"
    entries = [
        _family_entry("rwkv6-3b", h100, "s0.rwkv@1", 0.4412, 1.31),
        _family_entry("deepseek-moe-16b", h100, "s0.moe@2", 0.6667, 1.82),
        _family_entry("rwkv6-3b", other, "s0.rwkv@1", 0.4412, 0.5),
        _family_entry("rwkv6-3b", h100, "s0.rwkv@1", 0.4412, 0.7,
                      dtype="bfloat16"),
        _family_entry("rwkv6-3b", h100, "s0.rwkv@1", 0.4412, 1.47, chunk=16),
        _family_entry("zamba2-2.7b", h100, "s0.mamba@5", 0.8333, 0.93),
    ]
    path = str(tmp_path / "BENCH_history.jsonl")
    _write(path, entries, junk=False)
    for model in ("rwkv6-3b", "deepseek-moe-16b", "zamba2-2.7b", "absent"):
        for backend in (h100, other, "cpu"):
            for dtype in ("float32", "bfloat16", None):
                fp = {"model": model, "backend": backend}
                if dtype:
                    fp["dtype"] = dtype
                got = _rl().SuffixCostModel.calibrated(path, fingerprint=fp)
                want = ref.roofline.SuffixCostModel.calibrated(
                    path, fingerprint=fp)
                assert got.measured == want.measured, fp
    fp = {"model": "rwkv6-3b", "backend": h100}
    got = _rl().SuffixCostModel.calibrated(
        path, fingerprint=dict(fp, dtype="float32"))
    assert got.measured == ((0.4412, 0.5 * 1.31 + 0.5 * 1.47, 16),)
    got = _rl().SuffixCostModel.calibrated(
        path, fingerprint=dict(fp, dtype="bfloat16"))
    assert got.measured == ((0.4412, 0.7, 8),)
    # without the dtype both fold into one point
    got = _rl().SuffixCostModel.calibrated(path, fingerprint=fp)
    assert got.measured == ((0.4412, 0.5 * (0.5 * 1.31 + 0.5 * 0.7)
                             + 0.5 * 1.47, 16),)
    zamba = _rl().SuffixCostModel.calibrated(
        path, fingerprint={"model": "zamba2-2.7b", "backend": h100})
    assert not zamba.use_suffix(0.8333, 8)          # measured 0.93x: off
    assert _rl().SuffixCostModel().use_suffix(0.8333, 8)   # analytic: on


def test_calibrated_missing_or_empty_history_is_analytic(tmp_path):
    ref = reference()
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    legacy = str(tmp_path / "legacy.jsonl")
    _write(legacy, [], junk=True)
    for path in (str(tmp_path / "nope.jsonl"), str(empty), legacy):
        got = _rl().SuffixCostModel.calibrated(path, min_chunk=3)
        want = ref.roofline.SuffixCostModel.calibrated(path, min_chunk=3)
        assert got.measured is None and want.measured is None
        assert got == _rl().SuffixCostModel(min_chunk=3)
        assert got.use_suffix(0.5, 8) and not got.use_suffix(0.01, 8)
        assert not got.use_suffix(0.5, 2)


@pytest.mark.parametrize("min_speedup", [1.05, 1.5])
def test_calibrated_decisions_match_reference_over_a_grid(tmp_path,
                                                          min_speedup):
    """``predicted_speedup`` and ``use_suffix`` of a calibrated model, both
    packages, over fractions, chunk sizes and coverages: equal."""
    ref = reference()
    path = str(tmp_path / "h.jsonl")
    _write(path, REFERENCE_HISTORY)
    t = _rl().SuffixCostModel.calibrated(path, fingerprint={
        "model": "r18-mini"}, min_speedup=min_speedup)
    r = ref.roofline.SuffixCostModel.calibrated(path, fingerprint={
        "model": "r18-mini"}, min_speedup=min_speedup)
    decisions = set()
    for f in np.linspace(0.0, 1.0, 41).tolist() + [0.2, 0.5, 0.75, 1.3]:
        for n in (1, 2, 3, 4, 8, 16, 64):
            for c in (0.0, 0.1, 0.5, 0.75, 1.0):
                assert t.predicted_speedup(f, n, c) == \
                    r.predicted_speedup(f, n, c), (f, n, c)
                assert t.use_suffix(f, n, c) == r.use_suffix(f, n, c)
                decisions.add(t.use_suffix(f, n, c))
    assert decisions == {True, False}


# ------------------------------------------------- the analytic roofline


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_analytic_cell_active_params_equal_reference(arch):
    """Every config at every shape and mode, ``remat`` on and off: equal
    floats (the reduced config too)."""
    ref = reference()
    from repro_torch.configs import SHAPES, get_config
    rl = _rl()
    for tcfg, rcfg in ((get_config(arch), ref.configs.get_config(arch)),
                       (get_config(arch).reduced(),
                        ref.configs.get_config(arch).reduced())):
        assert rl.active_params(tcfg) == ref.roofline.active_params(rcfg)
        for name, shape in SHAPES.items():
            rshape = ref.configs.SHAPES[name]
            for mode in MODES:
                assert rl.model_flops(tcfg, shape, mode) == \
                    ref.roofline.model_flops(rcfg, rshape, mode)
                for remat in (True, False):
                    got = rl.analytic_cell(tcfg, shape, mode, remat=remat)
                    want = ref.roofline.analytic_cell(rcfg, rshape, mode,
                                                      remat=remat)
                    assert got == want, (name, mode, remat)
                    assert all(type(x) is float for x in got)


def test_h100_rates_are_the_cards_and_the_smoke_scripts():
    """The constants are the H100 SXM's, and ``chip_smoke.py`` bounds its
    kernels with these very numbers."""
    import chip_smoke
    rl = _rl()
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_TF32, rl.PEAK_FLOPS_F32,
            rl.HBM_BW, rl.LINK_BW) == (989e12, 495e12, 67e12, 3.35e12,
                                       450e9)
    assert chip_smoke.BF16_FLOP_PER_S == rl.PEAK_FLOPS
    assert chip_smoke.TF32_FLOP_PER_S == rl.PEAK_FLOPS_TF32
    assert chip_smoke.FP32_FLOP_PER_S == rl.PEAK_FLOPS_F32
    assert chip_smoke.HBM_BYTES_PER_S == rl.HBM_BW


_ROOF_CASES = [
    # (flops_per_device, bytes_per_device, collective, model, analytic
    #  flops, analytic bytes, chips)
    (0.0, 0.0, 256 * 50e9, 256 * 197e12 * 0.25, 256 * 197e12 * 0.5, 1.0,
     256),
    (3.1e13, 7.7e11, 0.0, 2.9e13, 0.0, 0.0, 1),
    (1e12, 5e12, 4e9, 8e11, 0.0, 2e12, 4),
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1),
    (2e15, 1e9, 1e15, 1e15, 3e15, 0.0, 8),
]


@pytest.mark.parametrize("case", _ROOF_CASES)
def test_roofline_equals_reference_with_its_rates(monkeypatch, case):
    """Properties and ``row()`` with the reference's (TPU v5e) rates, its
    peak passed in and the module's memory and link rates set to its own:
    the reference's values.  With the default rates the terms are the
    H100's."""
    ref = reference()
    fpd, bpd, coll, mf, af, ab, chips = case
    kw = dict(arch="a", shape="s", mesh="m", chips=chips,
              flops_per_device=fpd, bytes_per_device=bpd,
              collective_bytes_global=coll, model_flops_global=mf,
              analytic_flops_global=af, analytic_bytes_global=ab)
    R, rl = ref.roofline, _rl()
    want = R.Roofline(**kw)
    h100 = rl.Roofline(**kw)
    assert h100.t_collective == coll / (chips * 450e9)
    assert h100.t_memory == (ab / (chips * 3.35e12) if ab
                             else bpd / 3.35e12)
    assert h100.t_compute == (af / (chips * 989e12) if af
                              else fpd / 989e12)
    monkeypatch.setattr(rl, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(rl, "LINK_BW", R.LINK_BW)
    got = rl.Roofline(**kw, peak_flops=R.PEAK_FLOPS)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flops_ratio", "roofline_fraction",
                 "hlo_flops_global"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.row() == want.row()


def test_roofline_of_an_analytic_cell_at_the_float32_rate():
    """A float32 cell passes the float32 rate: its compute term is the
    bfloat16 one times 989 / 67."""
    from repro_torch.configs import SHAPES, get_config
    rl = _rl()
    cfg, shape = get_config("stablelm_1p6b"), SHAPES["train_4k"]
    flops, hbm = rl.analytic_cell(cfg, shape, "train")
    kw = dict(arch="stablelm_1p6b", shape="train_4k", mesh="1x1", chips=1,
              flops_per_device=0.0, bytes_per_device=0.0,
              collective_bytes_global=0.0,
              model_flops_global=rl.model_flops(cfg, shape, "train"),
              analytic_flops_global=flops, analytic_bytes_global=hbm)
    bf16 = rl.Roofline(**kw)
    f32 = rl.Roofline(**kw, peak_flops=rl.PEAK_FLOPS_F32)
    assert bf16.t_compute == flops / rl.PEAK_FLOPS
    assert f32.t_compute == flops / rl.PEAK_FLOPS_F32
    assert f32.bottleneck == bf16.bottleneck == "compute"
    # 6ND against 8ND (fwd + remat re-fwd + 2x bwd) of the matmuls
    assert 0.5 < bf16.roofline_fraction < 1.0
    assert f32.roofline_fraction == pytest.approx(bf16.roofline_fraction)


# ------------------------------------------------------- cell inputs


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Names, shapes and dtypes (int32 tokens, the config's float dtype)
    for every shape, on the ``"meta"`` device: nothing allocated."""
    ref = reference()
    from repro_torch.configs import SHAPES, get_config, input_specs
    for cfg, rcfg in ((get_config(arch), ref.configs.get_config(arch)),
                      (get_config(arch).reduced(),
                       ref.configs.get_config(arch).reduced())):
        for name, shape in SHAPES.items():
            got = input_specs(cfg, shape)
            want = ref.configs.input_specs(rcfg, ref.configs.SHAPES[name])
            assert list(got) == list(want)
            for k, spec in got.items():
                assert spec.device.type == "meta"
                assert tuple(spec.shape) == tuple(want[k].shape), (name, k)
                assert str(spec.dtype).split(".")[-1] == \
                    str(want[k].dtype), (name, k)


def _bits(a):
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy()
    return a.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", ["paligemma_3b", "stablelm_1p6b",
                                  "rwkv6_3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_inputs_bit_equal_to_reference(arch, dtype):
    """Reduced configs and small cells in every mode: tokens equal,
    prefix embeddings bit-equal, at two seeds."""
    ref = reference()
    from repro_torch.configs import ShapeCell, get_config, make_inputs
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                               dtype=dtype)
    for mode in MODES:
        for seed in (0, 5):
            got = make_inputs(cfg, ShapeCell("c", 16, 3, mode), seed=seed,
                              device="cpu")
            want = ref.configs.make_inputs(
                rcfg, ref.configs.ShapeCell("c", 16, 3, mode), seed=seed)
            assert list(got) == list(want)
            for k in want:
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(_bits(got[k]),
                                              _ref_bits(want[k]))


def test_make_inputs_rounds_bfloat16_twice_as_the_reference(monkeypatch):
    """Normals placed just above a bfloat16 midpoint, within float32's
    half-ulp of it: rounded once they go up to 1 + 2^-7, through float32
    (``jnp.asarray``'s way) to 1.  The port gives the reference's bits."""
    ref = reference()
    from repro_torch.configs import ShapeCell, get_config, make_inputs
    target = 1.0 + 2.0 ** -8 + np.arange(1, 33) * 2.0 ** -33

    class Rng:
        def __init__(self, seed):
            self.inner = np.random.Generator(np.random.PCG64(seed))

        def integers(self, *a, **kw):
            return self.inner.integers(*a, **kw)

        def normal(self, size):
            return np.resize(target / 0.02, size)
    monkeypatch.setattr(np.random, "default_rng", Rng)
    cfg = dataclasses.replace(get_config("paligemma_3b").reduced(),
                              dtype="bfloat16")
    rcfg = dataclasses.replace(ref.configs.get_config("paligemma_3b")
                               .reduced(), dtype="bfloat16")
    got = make_inputs(cfg, ShapeCell("c", 16, 1, "prefill"), device="cpu")
    want = ref.configs.make_inputs(
        rcfg, ref.configs.ShapeCell("c", 16, 1, "prefill"))
    pe = got["prefix_embeds"]
    np.testing.assert_array_equal(_bits(pe), _ref_bits(want["prefix_embeds"]))
    assert (pe.float() == 1.0).all()


# ------------------------------------------- chip_smoke.py's cost_model line


def test_smoke_cost_model_line_calibrates_each_family_that_wrote(tmp_path):
    """``chip_smoke.cost_model_line`` on a history the family sweeps wrote,
    in float32 and bfloat16: each family and dtype that wrote a mid-scan
    line gets its own measured points (the other dtype's timings do not
    move them) and, at each site, the analytic and calibrated decisions;
    a family that wrote none is left out; one whose lines the fingerprint
    does not find fails the script."""
    import chip_smoke
    card = "NVIDIA H100 80GB HBM3"
    path = str(tmp_path / "BENCH_history.jsonl")
    _write(path, [
        _family_entry("rwkv6-3b", card, "s0.rwkv@1", 0.5, 0.9, chunk=4),
        _family_entry("rwkv6-3b", card, "s0.rwkv@1", 0.5, 0.9, chunk=4),
        _family_entry("rwkv6-3b", card, "s0.rwkv@1", 0.5, 2.5, chunk=4,
                      dtype="bfloat16"),
        _family_entry("rwkv6-3b", card, "s0.rwkv@1", 0.5, 1.5, chunk=4,
                      dtype="bfloat16"),
        _family_entry("deepseek-moe-16b", card, "s0.moe@2", 0.6, 1.8,
                      chunk=4)], junk=True)
    mid = {"site": "s0.rwkv@1"}
    fracs = {"s0.rwkv@0": 0.0, "s0.rwkv@1": 0.5}

    def line(model, midscan, dtype="float32"):
        return {"model": model, "dtype": dtype, "chunk_size": 4,
                "site_prefix_fractions": fracs,
                "runs": {"batched": {"midscan": midscan},
                         "suffix": {"midscan": midscan}}}
    lines = [line("rwkv6-3b", mid), line("rwkv6-3b", mid, "bfloat16"),
             line("deepseek-moe-16b", mid), line("zamba2-2.7b", None)]
    got = chip_smoke.cost_model_line(lines, path, card)
    assert set(got["families"]) == {"rwkv6-3b", "deepseek-moe-16b"}
    assert set(got["families"]["rwkv6-3b"]) == {"float32", "bfloat16"}
    assert set(got["families"]["deepseek-moe-16b"]) == {"float32"}
    rwkv = got["families"]["rwkv6-3b"]["float32"]
    assert rwkv["midscan_lines"] == 2 and rwkv["chunk"] == 4
    assert rwkv["measured"] == [[0.5, 0.9, 4]]
    deep = rwkv["sites"][-1]
    assert deep["site"] == "s0.rwkv@1" and deep["analytic"] \
        and not deep["calibrated"]
    bf16 = got["families"]["rwkv6-3b"]["bfloat16"]
    assert bf16["measured"] == [[0.5, 0.5 * 2.5 + 0.5 * 1.5, 4]]
    assert bf16["sites"][-1]["calibrated"]
    assert got["families"]["deepseek-moe-16b"]["float32"]["sites"][-1][
        "calibrated"]
    assert got["seconds"] < 1.0
    with pytest.raises(SystemExit):
        chip_smoke.cost_model_line(lines, path, "another card")
    with pytest.raises(SystemExit):     # a dtype no line was written in
        chip_smoke.cost_model_line(
            [line("deepseek-moe-16b", mid, "bfloat16")], path, card)
