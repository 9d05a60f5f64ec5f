"""Dry run of the port: every (architecture × shape cell) on ``meta``, with
its roofline terms on one H100.

  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --cell train_4k
  python -m repro_torch.launch.dryrun --all [--out results/torch_dryrun]

Per cell it
  1. builds the abstract params, cache and batch on ``meta``
     (``models.abstract_model`` / ``abstract_cache``: shapes, no storage),
  2. runs the step once on them under ``launch.analysis``'s counter: a
     train cell ``models.model_loss`` and its backward on one microbatch
     (every microbatch is the same work, so the FLOPs are multiplied by
     their number), a prefill cell ``models.prefill``, a decode cell one
     ``models.decode_step`` — the kernels' wrappers take their meta route
     and report their ``cost``,
  3. records the param, cache and optimizer bytes, the step's peak live
     bytes, its FLOPs, the modeled HBM traffic (``memory_traffic``, the
     peak's bytes beyond the inputs standing in for XLA's temp size), the
     compute and memory times at the card's peaks, the dominant one, the
     model FLOPs (6 or 2 × active params × tokens), their share of the
     counted FLOPs and whether the step fits the card's memory,
  4. writes one JSON per cell (``--out``/singlepod/<arch>__<cell>.json).

Everything is a host-computed prediction: no kernel runs.  The card is
the one the records name, an NVIDIA H100 80GB HBM3 at 700 W: 989e12
dense bf16 FLOP/s, 3.35e12 B/s of HBM, 80 GB (on a card,
``torch.cuda.get_device_properties`` gives the memory).  One card only:
``--multi-pod`` and ``--profile dp`` raise (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.launch.analysis import (count_step, memory_traffic,
                                         tensors_of)

CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # dense bf16 tensor cores, per card
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9


def hbm_bytes() -> float:
    """The card's memory: the device's own where there is one."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of a (nested dict / list / pack) tree."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_batch(cfg, batch: int, seq: int, labels: bool = True
               ) -> Dict[str, torch.Tensor]:
    """The batch ``data.pipeline.make_batch`` would give, on ``meta``."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.is_encoder_decoder:
        out["src"] = _meta((batch, seq, cfg.d_model), torch.bfloat16)
        out["tokens"] = _meta((batch, seq), torch.int32)
    elif cfg.input_mode == "embeds":
        out["embeds"] = _meta((batch, seq, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    if labels:
        out["labels"] = _meta((batch, seq), torch.int32)
    return out


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def build_cell(arch: str, cell_name: str, multi_pod: bool = False,
               profile: str = "tp", microbatches: int = 0,
               remat_policy: str = "", sparse: bool = False):
    """→ (step fn, its meta args, meta dict)."""
    if multi_pod or profile != "tp":
        raise NotImplementedError(
            "the port's dry run covers one card; multi-pod meshes and the "
            "data-parallel profile come with ROADMAP queue 1 item 13")
    from repro_torch import configs as C
    from repro_torch import models as MZ
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import value_and_grad

    cfg = C._module(arch).sparse() if sparse else C.get(arch)
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    cell = C.CELLS[cell_name]
    if cell_name == "long_500k" and not cfg.sub_quadratic:
        raise ValueError(f"{arch} is full-attention; long_500k skipped")
    params = MZ.abstract_model(cfg, packed=sparse)
    meta = {
        "arch": cfg.name, "cell": cell_name, "kind": cell.kind,
        "seq": cell.seq, "batch": cell.batch, "chips": 1, "card": CARD,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "param_bytes_global": tree_bytes(params),
        "cache_bytes_global": 0, "opt_bytes": 0, "microbatches": 1,
    }

    if cell.kind == "train":
        n_micro = microbatches or cell.microbatches
        meta["opt_bytes"] = tree_bytes(
            {k: v for k, v in adamw_init(params).items()
             if k in ("mu", "nu")})
        meta["tokens_per_step"] = cell.batch * cell.seq
        meta["microbatches"] = n_micro
        batch = meta_batch(cfg, cell.batch // n_micro, cell.seq)

        def step(params, batch):
            return value_and_grad(
                lambda p, b: MZ.model_loss(p, cfg, b), params, batch)
        return step, (params, batch), meta

    src_len = cell.seq if cfg.is_encoder_decoder else None
    cache = MZ.abstract_cache(cfg, cell.batch, cell.seq, src_len=src_len)
    meta["cache_bytes_global"] = tree_bytes(cache)

    if cell.kind == "prefill":
        batch = meta_batch(cfg, cell.batch, cell.seq, labels=False)
        batch.pop("src", None)          # the Engine's null source
        meta["tokens_per_step"] = cell.batch * cell.seq

        @torch.no_grad()
        def step(params, batch, cache):
            return MZ.prefill(params, cfg, batch, cache)
        return step, (params, batch, cache), meta

    # decode: one new token per slot against a seq-long cache
    token = _meta((cell.batch,), torch.int32)
    pos = _meta((cell.batch,), torch.int32)
    meta["tokens_per_step"] = cell.batch

    @torch.no_grad()
    def step(params, token, cache, pos):
        return MZ.decode_step(params, cfg, token, cache, pos)
    return step, (params, token, cache, pos), meta


def run_cell(arch: str, cell_name: str, multi_pod: bool = False,
             profile: str = "tp", microbatches: int = 0,
             remat_policy: str = "", sparse: bool = False) -> Dict[str, Any]:
    t0 = time.time()
    step, args, meta = build_cell(arch, cell_name, multi_pod, profile,
                                  microbatches, remat_policy, sparse)
    meta["profile"] = profile
    meta["sparse"] = sparse
    count = count_step(step, *args)
    n_micro = meta["microbatches"]
    flops = count.flops * n_micro
    peak = count.peak_live_bytes + meta["opt_bytes"]
    mem = {"param_bytes": meta["param_bytes_global"],
           "cache_bytes": meta["cache_bytes_global"],
           "opt_bytes": meta["opt_bytes"],
           "entry_bytes": count.entry_bytes,
           "peak_live_bytes": count.peak_live_bytes,
           "temp_bytes": count.temp_bytes,
           "total_per_device": peak}
    traffic = memory_traffic(
        param_bytes_pd=meta["param_bytes_global"],
        temp_bytes_pd=count.temp_bytes,
        cache_bytes_pd=meta["cache_bytes_global"],
        opt_bytes_pd=meta["opt_bytes"], microbatches=n_micro)
    t_comp, t_mem = flops / PEAK_FLOPS, traffic / HBM_BW
    model_flops = (6 if meta["kind"] == "train" else 2) \
        * meta["active_params"] * meta["tokens_per_step"]
    rec = dict(meta)
    rec.update({
        "ok": True,
        "trace_s": round(time.time() - t0, 2),
        "memory": mem,
        "flops_per_device": flops,
        "flops_global": flops,
        "flops_terms": {
            "matmul": count.matmul_flops * n_micro,
            "conv": count.conv_flops * n_micro,
            "other": count.other_flops * n_micro,
            "kernels": {k: v * n_micro
                        for k, v in count.kernel_flops.items()}},
        "kernel_calls": {k: v * n_micro
                         for k, v in count.kernel_calls.items()},
        "hbm_traffic_pd": traffic,
        "collectives": {"bytes_by_kind": dict(count.collective_bytes),
                        "total_bytes": sum(count.collective_bytes.values())},
        "fits": peak <= hbm_bytes(),
        "roofline": {
            "t_compute_s": t_comp,
            "t_memory_s": t_mem,
            "t_collective_s": 0.0,
            "dominant": "compute" if t_comp >= t_mem else "memory",
            "model_flops": model_flops,
            "useful_flop_ratio": model_flops / flops if flops else 0.0,
            "bound_step_s": max(t_comp, t_mem),
        },
    })
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _out_path(out_dir: str, arch: str, cell: str) -> str:
    d = os.path.join(out_dir, "singlepod")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{cell}.json")


def run_all(out_dir: str, timeout: int, archs=None, cells=None,
            sparse: bool = False) -> int:
    """One subprocess per cell (a failure stays in its cell); cells whose
    JSON already says ``ok`` are skipped.  Returns the failures."""
    from repro_torch import configs as C
    failures = 0
    for arch in archs or C.list_archs():
        cfg = C.get(arch)
        for cell in C.cells_for(cfg):
            if cells and cell.name not in cells:
                continue
            path = _out_path(out_dir, cfg.name, cell.name)
            if os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {cfg.name} × {cell.name} (done)")
                        continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--cell", cell.name, "--out", out_dir]
            if sparse:
                cmd.append("--sparse")
            print(f"[run ] {cfg.name} × {cell.name}", flush=True)
            try:
                r = subprocess.run(cmd, timeout=timeout,
                                   capture_output=True, text=True)
            except subprocess.TimeoutExpired:
                failures += 1
                with open(path, "w") as f:
                    json.dump({"ok": False, "arch": arch, "cell": cell.name,
                               "error": f"timeout {timeout}s"}, f)
                print(f"[TIME] {cfg.name} × {cell.name}")
                continue
            if r.returncode != 0:
                failures += 1
                err = (r.stderr or "")[-2000:]
                with open(path, "w") as f:
                    json.dump({"ok": False, "arch": arch, "cell": cell.name,
                               "error": err}, f)
                print(f"[FAIL] {cfg.name} × {cell.name}:\n{err[-500:]}")
                continue
            with open(path) as f:
                rec = json.load(f)
            rl = rec["roofline"]
            print(f"[ ok ] {cfg.name} × {cell.name}: "
                  f"trace={rec['trace_s']}s "
                  f"mem={rec['memory']['total_per_device'] / 2**30:.2f}GiB "
                  f"dominant={rl['dominant']} "
                  f"step>={rl['bound_step_s'] * 1e3:.2f}ms", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--cells", nargs="*", default=None)
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--profile", default="tp", choices=["tp", "dp"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat-policy", default="")
    ap.add_argument("--sparse", action="store_true",
                    help="the paper-technique (packed sparse) config")
    args = ap.parse_args(argv)
    if args.multi_pod or args.profile != "tp":
        raise NotImplementedError(
            "--multi-pod and --profile dp are not served by the port yet "
            "(ROADMAP queue 1 item 13)")
    if args.all:
        return 1 if run_all(args.out, args.timeout, archs=args.archs,
                            cells=args.cells, sparse=args.sparse) else 0
    if not args.arch or not args.cell:
        ap.error("--arch and --cell required (or --all)")
    try:
        rec = run_cell(args.arch, args.cell, profile=args.profile,
                       microbatches=args.microbatches,
                       remat_policy=args.remat_policy, sparse=args.sparse)
    except Exception:
        traceback.print_exc()
        return 1
    path = _out_path(args.out, rec["arch"], args.cell)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("arch", "cell", "chips",
                                          "trace_s")}))
    print(json.dumps(rec["roofline"], indent=1))
    print(f"memory/device: {rec['memory']['total_per_device'] / 2**30:.2f} "
          f"GiB (fits: {rec['fits']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
