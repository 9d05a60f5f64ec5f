"""Serving example on the port: continuous batching over a small LM.

Boots the qwen3-family smoke model, submits a mixed-length request stream
through the port's ``Engine`` and serves it with the slot-based scheduler
(per-slot prefill, one host sync per decode chunk; on the card each chunk
after its key's first is a replayed CUDA graph).  ``serve_stream.py``
shows the streaming, mid-run admission and cancel surface.  The JAX
package's ``examples/serve_lm.py`` is the reference.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs as C
from repro_torch import models as MZ
from repro_torch.serving import Engine, ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = C.get_reduced("qwen3-0.6b")
    params = MZ.init_model(cfg, seed=0, device=args.device)

    scfg = ServeConfig(slots=4, max_len=256, prompt_pad=32,
                       max_new_tokens=24, temperature=0.0, eos_token=-1)
    engine = Engine(cfg, scfg, params, device=args.device)

    rng = np.random.default_rng(0)
    n_requests = 10
    handles = []
    for _ in range(n_requests):
        L = int(rng.integers(4, 32))
        handles.append(engine.submit(
            rng.integers(0, 1000, size=L).astype(np.int32)))
    print(f"submitted {n_requests} requests (len 4..31) into "
          f"{scfg.slots} slots")

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    ttfts = engine.ttfts_s()
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {engine.device}, median TTFT "
          f"{1e3 * sorted(ttfts)[len(ttfts) // 2]:.0f} ms)")
    for h in handles[:3]:
        print(f"  req {h.uid}: → {h.tokens[:8]}...")
    assert len(done) == n_requests
    print("ok")
    return {"requests": len(done), "tokens": toks,
            "syncs": engine.sync_count,
            "outputs": [h.tokens for h in handles]}


if __name__ == "__main__":
    main()
