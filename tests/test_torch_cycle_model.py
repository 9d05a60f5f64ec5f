"""The port's CFU cycle model and closed forms (``repro_torch.core.
cycle_model`` / ``analytical``) against the paper and against the JAX
package's: a twin of each test of ``tests/test_cycle_model.py`` on the
port's modules, then equal cycle counts, layer shapes and closed forms on
shared inputs.  Cycle counts are integers and must be equal; the closed
forms are float64 Python arithmetic, held to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import analytical as janalytical
from repro.core import cycle_model as jcycle
from repro.core import pruning as jpruning
from repro.models import cnn as jcnn
from repro_torch.core import analytical, cycle_model, pruning
from repro_torch.core.cycle_model import Design
from repro_torch.models import cnn

MODELS = ("vgg16", "resnet56", "mobilenetv2", "dscnn")


def iid_mask(seed, n, x):
    return np.random.default_rng(seed).random(n) >= x


# --- twins of tests/test_cycle_model.py --------------------------------------

class TestClosedForms:
    def test_ussa_cycles_linear(self):
        for x in (0.0, 0.25, 0.5, 0.9):
            assert analytical.ussa_cycles_analytical(x) == \
                pytest.approx(4 * (1 - x))

    def test_ussa_observed_adds_allzero_cycle(self):
        for x in (0.1, 0.5, 0.9):
            assert analytical.ussa_cycles_observed(x) == \
                pytest.approx(4 * (1 - x) + x ** 4)

    def test_fig8_bands(self):
        assert analytical.ussa_speedup_observed(0.5) > 1.9
        assert 2.0 <= analytical.ussa_speedup_observed(0.55)
        assert analytical.ussa_speedup_observed(0.75) <= 3.3

    def test_sssa_analytical(self):
        assert analytical.sssa_speedup_analytical(0.5) == pytest.approx(2.0)
        assert analytical.sssa_speedup_analytical(0.75) == pytest.approx(4.0)


class TestSimulatorMatchesAnalytical:
    @given(st.integers(0, 2**31), st.floats(0.05, 0.9))
    @settings(max_examples=15, deadline=None)
    def test_ussa_on_iid(self, seed, x):
        mask = iid_mask(seed, 40_000, x)
        cycles = cycle_model.stream_cycles(mask, Design.USSA,
                                           include_loop_overhead=False)
        expect = analytical.ussa_cycles_observed(x) * (len(mask) // 4)
        assert cycles == pytest.approx(expect, rel=0.08)

    def test_baselines(self):
        mask = iid_mask(0, 4000, 0.5)
        assert cycle_model.stream_cycles(
            mask, Design.BASELINE_SEQ, include_loop_overhead=False) == 4000
        assert cycle_model.stream_cycles(
            mask, Design.BASELINE_SIMD, include_loop_overhead=False) == 1000

    def test_sssa_skips_whole_runs(self):
        mask = np.zeros(64, bool)
        mask[:4] = True
        c = cycle_model.stream_cycles(mask, Design.SSSA)
        t = cycle_model.DEFAULT_TIMING
        assert c == t.simd_mac + t.inc_indvar + t.branch

    def test_sssa_cap_forces_landing(self):
        mask = np.zeros(4 * 22, bool)
        mask[:4] = True
        mask[-4:] = True
        c15 = cycle_model.stream_cycles(mask, Design.SSSA, cap=15)
        c4 = cycle_model.stream_cycles(mask, Design.SSSA, cap=4)
        assert c4 > c15


class TestFig9Crossover:
    def test_observed_exceeds_analytical_at_high_block_sparsity(self):
        rng = np.random.default_rng(5)
        w = rng.normal(size=(4096, 1)).astype(np.float32)
        _, mask = pruning.block_semi_structured(torch.from_numpy(w), 0.75,
                                                block=4)
        m = mask.numpy().astype(bool)[:, 0]
        base = cycle_model.stream_cycles(m, Design.BASELINE_SIMD)
        sssa = cycle_model.stream_cycles(m, Design.SSSA)
        assert base / sssa > analytical.sssa_speedup_analytical(0.75)


def combined_masks(layers, seed, x_ss, x_us):
    rng = np.random.default_rng(seed)
    masks = []
    for spec in layers:
        if spec.kind == "conv":
            h, w_, ci, co = spec.shape
            wt = rng.normal(size=(h * w_ * ci, co)).astype(np.float32)
        else:
            wt = rng.normal(size=spec.shape).astype(np.float32)
        _, mask = pruning.combined(torch.from_numpy(wt), x_ss=x_ss,
                                   x_us=x_us)
        masks.append(mask.numpy().reshape(spec.shape))
    return masks


class TestLayerAndModel:
    def test_conv_fast_matches_exact(self):
        rng = np.random.default_rng(7)
        mask = rng.random((3, 3, 8, 4)) > 0.5
        for d in (Design.BASELINE_SIMD, Design.USSA, Design.SSSA,
                  Design.CSA):
            exact = cycle_model.conv_layer_cycles(mask, (2, 2), d)
            fast = cycle_model.conv_layer_cycles_fast(mask, (2, 2), d)
            assert exact == fast, d

    def test_model_speedup_band(self):
        layers = [cycle_model.LayerShape("conv", (3, 3, 64, 32), (8, 8)),
                  cycle_model.LayerShape("linear", (128, 16))]
        masks = combined_masks(layers, 8, 0.5, 0.6)
        s = cycle_model.model_speedup(layers, masks, Design.CSA)
        assert 3.0 < s < 8.0, s

    def test_design_ordering(self):
        rng = np.random.default_rng(9)
        w = rng.normal(size=(1024, 4)).astype(np.float32)
        _, mask = pruning.combined(torch.from_numpy(w), x_ss=0.5, x_us=0.5)
        m = mask.numpy().astype(bool)
        layers = [cycle_model.LayerShape("linear", (1024, 4))]
        cyc = {d: cycle_model.model_cycles(layers, [m], d)
               for d in (Design.USSA, Design.SSSA, Design.CSA)}
        assert cyc[Design.CSA] <= cyc[Design.USSA]
        s_csa = cycle_model.model_speedup(layers, [m], Design.CSA)
        s_ussa = cycle_model.model_speedup(layers, [m], Design.USSA)
        s_sssa = cycle_model.model_speedup(layers, [m], Design.SSSA)
        assert s_csa >= s_ussa
        assert s_sssa > 1.0


# --- the port against the JAX package ----------------------------------------

def jdesign(d: Design):
    return jcycle.Design(d.value)


def structured_mask(seed, shape, x=0.6, zero_runs=True):
    """An i.i.d. mask with (optionally) runs of all-zero 4-blocks along
    the reduction axis (axis -2 of a conv, 0 of a stream), some longer
    than the 4-bit cap."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) >= x
    if zero_runs:
        flat = m.reshape(-1, shape[-1]) if len(shape) > 1 else m[:, None]
        flat[8:80] = False                       # 18 blocks, past the cap
    return m


@pytest.mark.parametrize("design", list(Design), ids=lambda d: d.value)
@pytest.mark.parametrize("cap", [15, 4])
@pytest.mark.parametrize("overhead", [True, False])
def test_stream_cycles_equal_jax(design, cap, overhead):
    for seed, x in ((0, 0.3), (1, 0.6), (2, 0.9)):
        m = structured_mask(seed, (4096,), x)
        got = cycle_model.stream_cycles(m, design, cap=cap,
                                        include_loop_overhead=overhead)
        want = jcycle.stream_cycles(m, jdesign(design), cap=cap,
                                    include_loop_overhead=overhead)
        assert got == want


@pytest.mark.parametrize("design", list(Design), ids=lambda d: d.value)
def test_conv_layer_cycles_equal_jax(design):
    m = structured_mask(3, (3, 3, 32, 8), 0.55)
    for fn, jfn in ((cycle_model.conv_layer_cycles,
                     jcycle.conv_layer_cycles),
                    (cycle_model.conv_layer_cycles_fast,
                     jcycle.conv_layer_cycles_fast)):
        assert fn(m, (5, 7), design) == jfn(m, (5, 7), jdesign(design))
    lin = structured_mask(4, (256, 12), 0.7)
    assert cycle_model.linear_layer_cycles(lin, design) == \
        jcycle.linear_layer_cycles(lin, jdesign(design))


@pytest.mark.parametrize("design", list(Design), ids=lambda d: d.value)
def test_model_cycles_equal_jax(design):
    """A whole model's cycles on masks the JAX ``combined`` pruner made:
    DS-CNN's layer list, every layer at (x_ss, x_us) = (0.6, 0.6)."""
    layers = cnn.layer_shapes("dscnn")
    jlayers = jcnn.layer_shapes("dscnn")
    rng = np.random.default_rng(11)
    masks = []
    for spec in jlayers:
        k = int(np.prod(spec.shape[:-1]))
        w = rng.normal(size=(k, spec.shape[-1])).astype(np.float32)
        _, mask = jpruning.combined(jnp.asarray(w), x_ss=0.6, x_us=0.6)
        masks.append(np.asarray(mask).reshape(spec.shape))
    got = cycle_model.model_cycles(layers, masks, design)
    want = jcycle.model_cycles(jlayers, masks, jdesign(design))
    assert got == want
    assert cycle_model.model_speedup(layers, masks, design) == \
        jcycle.model_speedup(jlayers, masks, jdesign(design))


@pytest.mark.parametrize("model", MODELS)
def test_layer_shapes_equal_jax(model):
    got = [(s.kind, tuple(s.shape), tuple(s.out_hw))
           for s in cnn.layer_shapes(model)]
    want = [(s.kind, tuple(s.shape), tuple(s.out_hw))
            for s in jcnn.layer_shapes(model)]
    assert got == want


XS = np.linspace(0.0, 0.95, 20)


@pytest.mark.parametrize("name", [
    "ussa_cycles_analytical", "ussa_cycles_observed",
    "ussa_speedup_analytical", "ussa_speedup_observed",
    "sssa_speedup_analytical"])
def test_closed_forms_equal_jax(name):
    for x in XS:
        got, want = (getattr(m, name)(float(x))
                     for m in (analytical, janalytical))
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_two_parameter_forms_equal_jax():
    for x_ss in (0.0, 0.3, 0.6):
        for x_us in (0.0, 0.5, 0.9):
            for fn in ("csa_cycles_analytical", "csa_speedup_analytical"):
                assert getattr(analytical, fn)(x_ss, x_us) == pytest.approx(
                    getattr(janalytical, fn)(x_ss, x_us), rel=1e-12)
            assert analytical.combined_flop_fraction(x_ss, 2, 4) == \
                pytest.approx(janalytical.combined_flop_fraction(x_ss, 2, 4),
                              rel=1e-12)
    for x in (0.1, 0.5, 0.99):
        assert analytical.expected_nonzero_tile_fraction(x, 16384) == \
            pytest.approx(janalytical.expected_nonzero_tile_fraction(
                x, 16384), rel=1e-12, abs=1e-12)
        assert analytical.block_speedup_tile(x, 0.1) == pytest.approx(
            janalytical.block_speedup_tile(x, 0.1), rel=1e-12)
    assert analytical.nm_flop_fraction(1, 4) == \
        janalytical.nm_flop_fraction(1, 4)
    np.testing.assert_allclose(
        analytical.sweep(analytical.ussa_speedup_observed, XS),
        janalytical.sweep(janalytical.ussa_speedup_observed, XS),
        rtol=1e-12)
