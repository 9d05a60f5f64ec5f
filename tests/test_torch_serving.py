"""What the parity tests do not reach: the port's configs field for field
against the JAX package's, the per-slot sampler, streaming handles,
seeded sampling, the dispatch plans an Engine records, and the key of a
built kernel library."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jax_qwen3
from repro.serving import ServeConfig as JServeConfig
from repro_torch import models
from repro_torch.configs import qwen3_0_6b
from repro_torch.core.sparse_linear import SparsityConfig, pack_params
from repro_torch.kernels import _build
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, ServeConfig, sample_token_slots
from test_torch_model import NM, TINY

SERVE = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=7,
             decode_chunk=3, eos_token=-1)
PROMPTS = [[1, 2, 3], [4, 5]]


@pytest.mark.parametrize("name", ["config", "reduced", "sparse"])
def test_qwen3_configs_equal_jax(name):
    port, ref = getattr(qwen3_0_6b, name)(), getattr(jax_qwen3, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_serve_config_equals_jax():
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(
        JServeConfig())
    for bad in (dict(slots=0), dict(max_len=128), dict(decode_chunk=0),
                dict(prefix_cache=True), dict(max_queue=-1)):
        with pytest.raises(ValueError):
            ServeConfig(**bad).validate()


@pytest.mark.parametrize("temp", [1.0, 0.5])
def test_sampler_rows_follow_their_temperature(temp):
    """Greedy rows take the argmax; sampled rows draw from
    softmax(logits / temp) (4000 draws, 4 standard errors)."""
    row = torch.from_numpy(np.random.default_rng(0).normal(
        size=5).astype(np.float32))
    n = 4000
    logits = row.expand(n, 5)
    temps = torch.tensor([0.0, temp]).repeat(n // 2)
    assert torch.equal(sample_token_slots(logits, temps, None),
                       logits.argmax(-1).to(torch.int32))
    draws = sample_token_slots(logits, temps,
                               torch.Generator().manual_seed(0))
    assert (draws[0::2] == row.argmax()).all()
    freq = torch.bincount(draws[1::2].long(), minlength=5) / (n // 2)
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(row / temp, -1).numpy(),
                               atol=0.045)


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    return cfg, models.init_model(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_handles_stream_what_generate_returns(tiny, page_size):
    cfg, params = tiny
    scfg = ServeConfig(**SERVE, page_size=page_size)
    want = Engine(cfg, scfg, params, device="cpu").generate(PROMPTS)
    eng = Engine(cfg, scfg, params, device="cpu")
    first, second = (eng.submit(p) for p in PROMPTS)
    assert list(first) == want[0]          # iterating drives step()
    assert second.result() == want[1]
    assert [len(w) for w in want] == [SERVE["max_new_tokens"]] * 2
    assert eng.sync_count == len(eng.stats().chunk_s)


def test_seeded_sampling_repeats_and_leaves_greedy_slots_alone(tiny):
    cfg, params = tiny
    scfg = ServeConfig(**SERVE, seed=3)

    def serve(temps):
        eng = Engine(cfg, scfg, params, device="cpu")
        hs = [eng.submit(p, temperature=t) for p, t in zip(PROMPTS, temps)]
        eng.run()
        return [h.tokens for h in hs]

    sampled, greedy = serve([1.0, 0.0]), serve([0.0, 0.0])
    assert sampled == serve([1.0, 0.0])
    assert sampled[0] != greedy[0] and sampled[1] == greedy[1]
    assert all(0 <= t < cfg.vocab_size for out in sampled for t in out)


def test_engine_plans_every_projection_on_nm_spmm():
    nm = SparsityConfig(**NM)
    cfg = ModelConfig(**TINY, mlp_sparsity=nm, attn_sparsity=nm)
    params = pack_params(models.init_model(cfg, seed=0, device="cpu"), cfg)
    scfg = ServeConfig(**SERVE)
    eng = Engine(cfg, scfg, params, device="cpu")
    for plan, M in ((eng.prefill_plan, scfg.prompt_pad),
                    (eng.decode_plan, scfg.slots)):
        assert len(plan) == 7 * cfg.n_layers
        assert {(p["kernel"], p["mode"], p["pattern"], p["M"])
                for p in plan} == {("nm_spmm", "ref", "2:4g128", M)}


def test_engine_refuses_a_missing_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, ServeConfig(**SERVE), params)


def test_kernel_library_is_keyed_by_its_sources(tmp_path, monkeypatch):
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(tmp_path / "nm_spmm.cu", "a") as f:
        f.write("\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert after["nm_spmm"] != before["nm_spmm"]
    assert all(after[n] == before[n] for n in _build.SOURCES
               if n != "nm_spmm")
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("\n")
    assert all(_build._lib_path(n) != after[n] for n in _build.SOURCES)
