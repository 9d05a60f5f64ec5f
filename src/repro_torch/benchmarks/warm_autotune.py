"""Offline autotune warmer of the port: sweep the serving keys into the
autotune cache before the first request needs them.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --warm-autotune \\
      [--slots 8] [--prompt-pad 128] [--device cuda]

The engine's launches run at the serving geometries: ``M = slots`` rows
at decode, ``M = prompt_pad`` at a per-slot refill, ``M = slots * (k +
1)`` at a speculative verify of depth ``k`` (``SPEC_KS``) and ``M =
slots * prompt_pad`` for a wave.  This module times every candidate
plan (``kernels/tiling.py``, through ``dispatch.tune``) of each distinct
packed MLP weight of the ``nm`` and ``combined`` serving models at those
rows, and of ``paged_attention`` at the decode geometry of each page
view the engine may take (one query per slot, and ``k + 1`` for the
verify blocks), and persists the winners (``REPRO_TORCH_AUTOTUNE_CACHE``
or ``~/.cache/repro_torch/autotune.json``).  On the card the sweeps time
the hand-written kernels with CUDA events; on the CPU (``device="cpu"``)
they run the plain versions under ``ref`` keys, exercising the cache on
the same geometry (the wave rows are skipped there, as the JAX warmer
skips them off the TPU).

The models default to ``bench_serving``'s; ``models`` and ``paged`` take
others (``chip_smoke.py`` warms qwen3-0.6b's).  The shard-local keys of
tensor-parallel serving (``_shard_keys``, ``_tp_model``) come with
ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.sparsity import PACK_TYPES
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import PagedKV

SPEC_KS = (2, 4, 8)     # verify-block depths the spec rows serve at
FORMATS = ("nm", "combined")


def serving_ms(slots: int, prompt_pad: int, wave: bool) -> List[int]:
    """The rows the engine launches the MLP kernels at: decode, refill,
    the verify blocks and (``wave``) a whole wave."""
    ms = {slots, prompt_pad}
    ms.update(slots * (k + 1) for k in SPEC_KS)
    if wave:
        ms.add(slots * prompt_pad)
    return sorted(ms)


def paged_views(scfg) -> List[int]:
    """The page views a paged engine's decode chunks take: multiples of
    ``page_view_chunk`` up to ``max_pages`` (``backends``' rule), or the
    whole table."""
    vc = scfg.page_view_chunk
    if not vc:
        return [scfg.max_pages]
    return sorted({min(v, scfg.max_pages)
                   for v in range(vc, scfg.max_pages + vc, vc)})


def layer_packs(params) -> List:
    """The distinct packs of a param tree, one per (kind, pattern, K,
    N)."""
    seen, packs = set(), []

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, PACK_TYPES):
            d = dispatch.SparsityDescriptor.of(node, nominal=True)
            key = (d.kind, d.pattern, d.K, d.N)
            if key not in seen:
                seen.add(key)
                packs.append(node)

    visit(params)
    return packs


def _shard_keys(*args, **kwargs):
    raise NotImplementedError("shard-local autotune keys come with "
                              "tensor parallelism (ROADMAP queue 1 item 13)")


def _tp_model(*args, **kwargs):
    raise NotImplementedError("shard-local autotune keys come with "
                              "tensor parallelism (ROADMAP queue 1 item 13)")


def _default_models(device) -> Dict[str, tuple]:
    from repro_torch.benchmarks.bench_serving import _model
    return {fmt: _model(fmt, device) for fmt in FORMATS}


def _default_paged() -> List[dict]:
    from repro_torch.benchmarks import bench_serving as BS
    scfg = BS._het_scfg()
    return [dict(H=4, Hk=2, D=BS.D_MODEL // 4, page_size=BS.HET_PAGE,
                 views=paged_views(scfg), window=None)]


def _entry(key: str, cache, plan: dict, was_cached: bool,
           skipped_before: int) -> dict:
    e = cache.get(key) or {}
    return {"key": key, "plan": plan, "cached": was_cached,
            "us": e.get("us"), "rule_us": e.get("rule_us"),
            "skipped": dispatch.skipped - skipped_before}


def run(slots: int = 8, prompt_pad: int = 128, reps: int = 10,
        device="cuda", models: Optional[Dict[str, tuple]] = None,
        paged: Optional[Sequence[dict]] = None,
        device_counts: Sequence[int] = ()) -> dict:
    """Sweep and persist; returns ``{"entries": [...], ...}``, one entry
    per key: its plan, whether it was cached before, the winner's and
    the rule's µs and the candidates skipped.

    ``models`` maps a format to ``(cfg, params)`` on ``device``;
    ``paged`` lists ``{"H", "Hk", "D", "page_size", "views", "window"}``
    geometries (bfloat16 pools) — match the target engine's
    ``ServeConfig``: the keys carry M and the view."""
    if device_counts:
        _shard_keys()
    device = dispatch.resolve_device(device)
    on_card = device.type == "cuda"
    cache = dispatch.autotune_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    entries = []
    t0 = time.time()
    models = _default_models(device) if models is None else models
    for fmt, (cfg, params) in models.items():
        for pack in layer_packs(params):
            dtype = dispatch._x_dtype(pack)
            for M in serving_ms(slots, prompt_pad, wave=on_card):
                x = torch.randn((M, pack.K), generator=gen, device=device
                                ).to(dtype)
                entry = dispatch._entry_for(
                    dispatch.SparsityDescriptor.of(pack, nominal=True).kind)
                key = dispatch._weight_key(entry, M, pack, dtype,
                                           dispatch.ARCH if on_card
                                           else "ref")
                was_cached, before = cache.get(key) is not None, \
                    dispatch.skipped
                plan = dispatch.tune(x, pack, reps=reps)
                entries.append(dict(_entry(key, cache, plan, was_cached,
                                           before), format=fmt))
    for g in (_default_paged() if paged is None else paged):
        for view in g["views"]:
            P = slots * view + 1
            pool = torch.zeros((P, g["page_size"], g["Hk"], g["D"]),
                               dtype=torch.bfloat16, device=device)
            ptab = torch.arange(1, P, dtype=torch.int32, device=device
                                ).reshape(slots, view)
            for Q in [1] + [k + 1 for k in SPEC_KS]:
                lens = torch.full((slots,), view * g["page_size"],
                                  dtype=torch.int32, device=device)
                kv = PagedKV(pool, pool, ptab, lens)
                shape = (slots, g["H"], g["D"]) if Q == 1 else \
                    (slots, Q, g["H"], g["D"])
                q = torch.randn(shape, generator=gen, device=device
                                ).to(torch.bfloat16)
                key = dispatch.paged_key(
                    slots, g["H"], g["Hk"], Q, view, g["D"],
                    (torch.bfloat16, torch.bfloat16), g["page_size"],
                    g["window"], dispatch.ARCH if on_card else "ref")
                was_cached, before = cache.get(key) is not None, \
                    dispatch.skipped
                plan = dispatch.tune(q, kv, reps=reps, window=g["window"])
                entries.append(dict(_entry(key, cache, plan, was_cached,
                                           before), format="paged"))
    return {"entries": entries, "device": str(device),
            "wall_s": time.time() - t0, "cache_path": cache.path,
            "cache_size": len(cache)}


def main(out=None) -> None:
    if out is None:
        out = run()
    print(f"# autotune warm: {len(out['entries'])} serving keys swept on "
          f"{out['device']} ({out['wall_s']:.1f} s)")
    for e in out["entries"]:
        print(f"  {e['key']} -> {e['plan']} (us {e['us']}, rule "
              f"{e['rule_us']}, skipped {e['skipped']})")
    print(f"cache: {out['cache_path']} ({out['cache_size']} entries)")


if __name__ == "__main__":
    main()
