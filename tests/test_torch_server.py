"""The port's deprecated ``Server`` shim (``repro_torch.serving.engine``)
against the JAX ``Server`` on ``tests/test_serving.py``'s scripts.

Both serve the same float32 TINY weights (``test_torch_model``'s qwen3-
style config, converted from the JAX init) on the CPU; one JAX ``Server``
is built per ``ServeConfig`` and the scripts that share a config run on
it back to back, so both sides see the same calls.  Greedy tokens must
be equal; the sync contract is counted at the shim's ``_device_fetch``,
the engine's one fetch point.
"""

import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.serving import ServeConfig as JServeConfig
    from repro.serving import Server as JServer
    import repro_torch.serving.engine as tengine
from repro_torch import models as TM
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_model import build_params, jax_mesh

BATCHED = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=16,
               decode_chunk=4, eos_token=-1)


@pytest.fixture(scope="module")
def params():
    return build_params("dense")


@pytest.fixture(scope="module")
def servers(params):
    """``servers(name, **scfg)`` → (JAX Server, port Server), built once
    per name."""
    jcfg, jp, tcfg, tp = params
    made = {}

    def get(name, **kw):
        if name not in made:
            made[name] = (JServer(jcfg, jax_mesh(), JServeConfig(**kw), jp),
                          tengine.Server(tcfg, TServeConfig(**kw), tp,
                                         device="cpu"))
        return made[name]
    return get


def serve(server, prompts, budgets=None):
    uids = [server.submit(p, max_new=n) for p, n in
            zip(prompts, budgets or [None] * len(prompts))]
    done = {r.uid: r.out for r in server.run()}
    return [done[u] for u in uids]


def test_import_warns_once_and_keeps_the_old_names():
    import importlib
    import sys
    mod = sys.modules.pop("repro_torch.serving.engine")
    try:
        with pytest.warns(DeprecationWarning, match="deprecated v1"):
            importlib.import_module("repro_torch.serving.engine")
    finally:
        sys.modules["repro_torch.serving.engine"] = mod
    for name in ("build_decode_loop", "build_paged_decode_loop",
                 "build_prefill_slot_step", "build_paged_prefill_slot_step",
                 "build_prefill_wave_step", "build_prefill_step",
                 "build_decode_step", "build_spec_decode_loop", "Engine",
                 "Request", "ServeConfig", "_device_fetch"):
        assert hasattr(tengine, name), name


def test_greedy_matches_manual_decode_and_jax(params, servers):
    """The shim's output equals a hand-rolled prefill + decode on the
    port and the JAX ``Server``'s."""
    jcfg, jp, tcfg, tp = params
    kw = dict(slots=1, max_len=64, prompt_pad=8, max_new_tokens=6,
              eos_token=-1)
    jserver, tserver = servers("single", **kw)
    prompt = np.arange(1, 9, dtype=np.int32)
    out = serve(tserver, [prompt])[0]
    assert out == serve(jserver, [prompt])[0]
    cache = TM.init_cache(tcfg, 1, 64, device="cpu")
    logits, cache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
        prompt[None])}, cache)
    tok = logits[:, :tcfg.vocab_size].argmax(-1).to(torch.int32)
    manual = [int(tok[0])]
    for pos in range(8, 13):
        logits, cache = TM.decode_step(tp, tcfg, tok, cache,
                                       torch.tensor([pos], dtype=torch.int32))
        tok = logits[:, :tcfg.vocab_size].argmax(-1).to(torch.int32)
        manual.append(int(tok[0]))
    assert out == manual


def test_batched_scripts_match_jax(servers):
    """test_serving's batched scripts on one config: five requests on two
    slots (three waves), identical prompts, and three budgets with a
    refill mid-stream — uids, lengths and tokens as the JAX Server's."""
    jserver, tserver = servers("batched", **BATCHED)
    five = [np.arange(1, 6, dtype=np.int32)] * 5
    got, want = serve(tserver, five, [4] * 5), serve(jserver, five, [4] * 5)
    assert got == want and all(len(o) == 4 for o in got)
    same = [np.asarray([5, 6, 7], np.int32)] * 2
    got = serve(tserver, same, [4, 4])
    assert got[0] == got[1] == serve(jserver, same, [4, 4])[0]
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(3, 11, dtype=np.int32),
               np.asarray([7, 9, 11], np.int32)]
    got = serve(tserver, prompts, [5, 9, 3])
    assert got == serve(jserver, prompts, [5, 9, 3])
    assert [len(o) for o in got] == [5, 9, 3]
    assert sorted(r.uid for r in tserver.finished) == \
        sorted(r.uid for r in jserver.finished)


def test_one_sync_per_chunk(servers, monkeypatch):
    """Exactly ceil(tokens / decode_chunk) transfers, counted at the
    shim's fetch point (prefills sync nothing)."""
    _, tserver = servers("batched", **BATCHED)
    calls = []
    orig = tengine._device_fetch
    monkeypatch.setattr(tengine, "_device_fetch",
                        lambda t: calls.append(1) or orig(t))
    tserver.reset_stats()
    out = serve(tserver, [np.arange(1, 6, dtype=np.int32)] * 2, [8, 8])
    assert all(len(o) == 8 for o in out)
    assert len(calls) == 2 and tserver.sync_count == 2


def test_eos_stops_mid_chunk(params, servers):
    """Re-serve with eos set to the third token of the free run: both
    outputs truncate right after it, as the JAX Server's does."""
    prompt = np.arange(1, 9, dtype=np.int32)
    jserver, tserver = servers("batched", **BATCHED)
    free = serve(tserver, [prompt], [12])[0]
    assert free == serve(jserver, [prompt], [12])[0]
    eos = free[2]
    kw = dict(slots=1, max_len=64, prompt_pad=8, max_new_tokens=12,
              decode_chunk=8, eos_token=eos)
    jserver, tserver = servers("eos", **kw)
    out = serve(tserver, [prompt])[0]
    assert out == serve(jserver, [prompt])[0] == free[:free.index(eos) + 1]


def test_temperature_chunked_runs(params):
    """The sampling path through the chunked loop: deterministic per seed,
    the right count, in-vocab tokens (the two frameworks' generators
    differ, so only the port is compared with itself)."""
    _, _, tcfg, tp = params
    scfg = TServeConfig(slots=2, max_len=64, prompt_pad=8, max_new_tokens=6,
                        decode_chunk=4, temperature=0.7, eos_token=-1,
                        seed=3)
    outs = []
    for _ in range(2):
        server = tengine.Server(tcfg, scfg, tp, device="cpu")
        outs.append(serve(server, [np.arange(1, 6, dtype=np.int32)])[0])
    assert outs[0] == outs[1] and len(outs[0]) == 6
    assert all(0 <= t < tcfg.vocab_size for t in outs[0])


def test_stats_and_plans_are_the_engines(servers):
    _, tserver = servers("batched", **BATCHED)
    eng = tserver.engine
    assert tserver.prefill_plan is eng.prefill_plan
    assert tserver.decode_plan is eng.decode_plan
    assert tserver.stats() == eng.stats()
    assert tserver.scfg is eng.scfg and tserver.queue is eng.queue
