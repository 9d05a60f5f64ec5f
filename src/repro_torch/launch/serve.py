"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Boots a model (seeded random init, or the newest checkpoint under
``--checkpoint-dir``), starts the port's continuous-batching ``Engine``
on one device (``--device``, the card by default), feeds it the JAX
launcher's synthetic request stream (prompts from
``np.random.default_rng(seed)``) and prints its one-line JSON report.

Examples:
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --requests 16 --max-new 32 --device cpu
  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16 \\
      --slots 8 --prompt-len 128 --prompt-pad 128 --max-len 512 \\
      --max-new 64 --page-size 16 --decode-chunk 16

The report has the JAX report's keys, its robustness counters
(``timeouts`` … ``degraded_recoveries``) included: ``--max-queue``
bounds the admission queue and ``--deadline-ms`` gives every request a
wall-clock budget.  ``--journal`` writes the write-ahead request journal;
``--supervise`` (which needs ``--journal``) serves under the crash-safe
``Supervisor`` with ``--snapshot-dir``/``--snapshot-every`` snapshots and
a ``--watchdog-ms`` watchdog, and the report gains ``restarts``,
``recovery_ms`` and ``last_recovery`` (the last recovery's timings).
Every launch is a fresh serve: it refuses a ``--journal`` file or a
``--snapshot-dir`` that an earlier serve left.
Flags of unported work raise ``NotImplementedError`` when given another
value than their default: ``--model-parallel`` and ``--devices`` (ROADMAP
queue 1 item 13).

``--dry-run`` builds nothing: it runs the per-slot prefill and one decode
chunk of the paged serving loops on ``meta`` tensors (``--page-size``,
16 by default) and prints their peak live bytes and FLOPs, the param and
cache bytes, the pool's pages and the dispatch plan rows with the
launch plans the card would run (``launch.analysis``; host-computed, no
kernel runs).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

#: flag (its ``args`` name) → the ROADMAP queue 1 item that ports it
NOT_PORTED = {"model_parallel": "item 13", "devices": "item 13"}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-pad", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=16,
                    help="on-card decode steps per host sync")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV rows per cache page; >0 switches the KV cache "
                         "to the paged layout")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="allocatable pages in the shared pool; 0 sizes it "
                         "at full capacity (slots x max_len)")
    ap.add_argument("--prompt-buckets", type=int, default=0,
                    help="paged only: pad each prompt to a multiple of "
                         "this instead of the uniform --prompt-pad")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged only: share resident prompt pages across "
                         "requests (radix index + copy-on-write)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="with --prefix-cache: pin a random shared head of "
                         "this many tokens (a --page-size multiple) and "
                         "lead every request with it")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: tokens drafted per verify "
                         "step (0 disables)")
    ap.add_argument("--spec-draft", default="pack", choices=("pack", "self"),
                    help="drafter weights: 'pack' = the model packed into "
                         "its configured sparse formats, 'self' = the "
                         "verify weights themselves")
    ap.add_argument("--no-spec", action="store_true",
                    help="force speculation off (overrides --spec-k)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="restore {'params': ...} from the newest valid "
                         "checkpoint here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue: submissions past it "
                         "are rejected (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request wall-clock budget from submission; "
                         "past it the request times out (0 = none)")
    ap.add_argument("--supervise", action="store_true",
                    help="serve under the crash-safe supervisor: a step() "
                         "failure (an injected crash included) or a hang "
                         "past --watchdog-ms tears the engine down and "
                         "restores it from the journal and the latest "
                         "snapshot (needs --journal)")
    ap.add_argument("--journal", default="",
                    help="write-ahead request journal path (append-only "
                         "JSONL, fsync'd at chunk boundaries)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="engine snapshot directory (with --supervise)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot every N scheduler ticks (0 = never)")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="with --supervise: a step slower than this, past "
                         "the grace steps and graph captures, counts as a "
                         "hung engine (0 = off)")
    # the JAX launcher's flags of work the port has not taken yet
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    for name, item in NOT_PORTED.items():
        if getattr(args, name) != ap.get_default(name):
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not served by the port yet (ROADMAP queue 1 "
                f"{item})")
    if args.dry_run:
        print(json.dumps(dry_run(args)))
        return 0
    if args.supervise and not args.journal:
        ap.error("--supervise needs --journal (recovery replays it)")
    from repro_torch.serving.journal import earlier_serve
    stale = earlier_serve(args.journal, args.snapshot_dir)
    if stale is not None:           # every launch is a fresh serve
        ap.error(stale)

    from repro_torch import configs as C
    from repro_torch import models as MZ
    from repro_torch.checkpoint import restore_latest
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.serving import Engine, ServeConfig, Supervisor

    device = resolve_device(args.device)
    mod = C._module(args.arch)
    cfg = mod.reduced() if args.reduced else mod.config()
    params = MZ.init_model(cfg, seed=args.seed, device=device)
    if args.checkpoint_dir:
        restored = restore_latest(args.checkpoint_dir, {"params": params},
                                  device=device)
        if restored is not None:
            params = restored[0]["params"]
            print(f"restored checkpoint step {restored[1]}")

    spec_k = 0 if args.no_spec else args.spec_k
    scfg = ServeConfig(slots=args.slots, max_len=args.max_len,
                       prompt_pad=args.prompt_pad,
                       max_new_tokens=args.max_new,
                       decode_chunk=args.decode_chunk,
                       temperature=args.temperature, seed=args.seed,
                       page_size=args.page_size, num_pages=args.num_pages,
                       prompt_buckets=args.prompt_buckets,
                       prefix_cache=args.prefix_cache,
                       max_queue=args.max_queue,
                       spec_k=spec_k, spec_draft=args.spec_draft,
                       journal_path=args.journal)
    if args.supervise:
        server = Supervisor(cfg, scfg, params, device=device,
                            journal_path=args.journal,
                            snapshot_dir=args.snapshot_dir,
                            snapshot_every=args.snapshot_every,
                            watchdog_ms=args.watchdog_ms)
    else:
        server = Engine(cfg, scfg, params, device=device)

    rng_np = np.random.default_rng(args.seed)
    handle = None
    if args.shared_prefix:
        handle = server.register_prefix(rng_np.integers(
            0, min(cfg.vocab_size, 1024),
            size=args.shared_prefix).astype(np.int32))
    for _ in range(args.requests):
        # pinned-head sharing needs equal padded heads (left-padding), so
        # the suffix length is fixed when a prefix is pinned
        L = (args.prompt_len if handle is not None
             else int(rng_np.integers(4, args.prompt_len + 1)))
        server.submit(rng_np.integers(
            0, min(cfg.vocab_size, 1024), size=L).astype(np.int32),
            prefix=handle, deadline_ms=args.deadline_ms or None)

    t0 = time.time()
    done = server.run()
    dt = time.time() - t0
    stats = server.stats()
    toks = sum(len(r.out) for r in done)
    ttfts = sorted(server.ttfts_s())
    report = {
        "arch": cfg.name, "requests": len(done),
        "generated_tokens": toks, "wall_s": round(dt, 2),
        "tok_per_s": round(toks / dt, 1),
        "ttft_p50_ms": round(1e3 * ttfts[len(ttfts) // 2], 2)
        if ttfts else None,
        "decode_chunk": scfg.decode_chunk,
        "host_syncs": stats.sync_count,
        "prefills": stats.prefills,
        "kv_cache_mb": round(stats.cache_bytes / 2**20, 2),
        # robustness counters: every contained fault shows up here
        "timeouts": stats.timeouts,
        "rejections": stats.rejections,
        "preemptions": stats.preemptions,
        "numeric_faults": stats.numeric_faults,
        "kernel_failures": stats.kernel_failures,
        "fetch_errors": stats.fetch_errors,
        "degraded": stats.degraded,
        "degraded_recoveries": stats.degraded_recoveries,
    }
    if args.supervise:
        report.update({
            "restarts": server.restarts,
            "recovery_ms": round(
                server.last_recovery.get("total_ms", 0.0), 1),
            "last_recovery": {k: round(v, 1) for k, v in
                              server.last_recovery.items()},
        })
    if scfg.paged:
        report.update({
            "page_size": scfg.page_size,
            "pool_pages": scfg.pool_pages,
            "peak_pages": stats.peak_pages,
            "admission_waits": stats.admission_waits,
        })
    if scfg.prefix_cache:
        report.update({
            "prefix_hits": stats.prefix_hits,
            "shared_pages": stats.shared_pages,
            "cow_copies": stats.cow_copies,
        })
    if scfg.spec:
        report.update({
            "spec_k": scfg.spec_k,
            "spec_draft": scfg.spec_draft,
            "drafted_tokens": stats.drafted,
            "accepted_tokens": stats.accepted,
            "acceptance_rate": round(stats.acceptance_rate, 4),
        })
    print(json.dumps(report))
    return 0


def dry_run(args) -> dict:
    """The serving programs on ``meta`` (see the module docstring): the
    counterpart of the JAX launcher's AOT compile of the per-slot prefill
    and the chunked decode loop."""
    import torch

    from repro_torch import configs as C
    from repro_torch import models as MZ
    from repro_torch.kernels import dispatch
    from repro_torch.launch.analysis import count_step
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.serving import ServeConfig, init_decode_state, loops

    t0 = time.time()
    mod = C._module(args.arch)
    cfg = mod.reduced() if args.reduced else mod.config()
    scfg = ServeConfig(slots=args.slots, max_len=args.max_len,
                       prompt_pad=args.prompt_pad,
                       max_new_tokens=args.max_new,
                       decode_chunk=args.decode_chunk,
                       page_size=args.page_size or 16,
                       num_pages=args.num_pages, seed=args.seed)
    params = MZ.abstract_model(cfg)
    cache = MZ.abstract_cache(cfg, scfg.slots, scfg.max_len,
                              page_size=scfg.page_size,
                              num_pages=scfg.pool_pages)

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def program(count) -> dict:
        return {"flops": count.flops, "kernel_calls": count.kernel_calls,
                "memory": {"entry_bytes": count.entry_bytes,
                           "peak_live_bytes": count.peak_live_bytes,
                           "temp_bytes": count.temp_bytes}}

    state = init_decode_state(scfg.slots, "meta")
    prefill = loops.build_prefill_slot_step(cfg, scfg, scfg.prompt_pad,
                                            paged=True)
    decode = loops.build_decode_loop(cfg, scfg, paged=True)
    with torch.no_grad():
        programs = {
            "prefill_slot": program(count_step(
                prefill, params, meta((1, scfg.prompt_pad)), cache, state,
                0, scfg.max_new_tokens, 0.0, None, meta((scfg.max_pages,)))),
            "decode_chunk": program(count_step(
                decode, params, cache, state,
                meta((scfg.slots,), torch.float32), None,
                meta((scfg.slots, scfg.max_pages))))}
    plans = {"prefill": dispatch.plan_params(
                 params, scfg.prompt_pad, "meta",
                 MZ.expert_rows(cfg, scfg.prompt_pad), with_plans=True),
             "decode": dispatch.plan_params(
                 params, scfg.slots, "meta", MZ.expert_rows(cfg, scfg.slots),
                 with_plans=True)}
    return {
        "arch": cfg.name, "dry_run": True, "devices": 1,
        "params": cfg.param_count(),
        "param_bytes_global": tree_bytes(params),
        "cache_bytes_global": tree_bytes(cache),
        "slots": scfg.slots, "max_len": scfg.max_len,
        "page_size": scfg.page_size, "pool_pages": scfg.pool_pages,
        "decode_chunk": scfg.decode_chunk,
        "programs": programs,
        "plan_rows": {k: len(v) for k, v in plans.items()},
        "decode_plan_sample": plans["decode"][:3],
        "wall_s": round(time.time() - t0, 2),
    }


if __name__ == "__main__":
    raise SystemExit(main())
