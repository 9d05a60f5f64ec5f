"""Streaming-serving example on the port: the ``Engine`` request API.

On a tiny LM (d_model 64 over 4 heads: head dim 16) over the paged KV
cache:

  * ``submit()`` returns a handle at once, with no drain-the-queue call;
  * ``step()`` is one scheduler tick (admit + prefill + one decode chunk,
    a single device→host sync) returning ``TokenEvent``s;
  * a request submitted mid-run is admitted into a slot an earlier
    request freed, without stalling the live ones;
  * iterating a handle streams its tokens in order;
  * ``cancel()`` retires a request at the next chunk boundary.

The JAX package's ``examples/serve_stream.py`` is the reference.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_stream [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import models as MZ
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, RequestStatus, ServeConfig

CFG = ModelConfig(name="stream-demo", n_layers=2, d_model=64,
                  vocab_size=512, n_heads=4, n_kv_heads=2, d_ff=128,
                  remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params = MZ.init_model(CFG, seed=0, device=args.device)

    scfg = ServeConfig(slots=2, max_len=128, prompt_pad=16,
                       max_new_tokens=12, decode_chunk=4,
                       eos_token=-1, page_size=16)
    engine = Engine(CFG, scfg, params, device=args.device)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(1, CFG.vocab_size, size=n).astype(np.int32)

    t0 = time.time()
    # two requests up front, driven tick by tick
    a = engine.submit(prompt(9), max_new=8, stream=True)
    b = engine.submit(prompt(14), max_new=12, stream=True)
    events = engine.step()
    print(f"tick 1: {len(events)} tokens from "
          f"{sorted({e.uid for e in events})} (one host sync)")

    # mid-run submission: c queues now, lands in the slot a frees
    c = engine.submit(prompt(5), max_new=6, stream=True)
    while not a.done:
        engine.step()
    print(f"req {a.uid} done after {len(a.tokens)} tokens "
          f"(TTFT {1e3 * a.ttft_s:.1f} ms)")

    # cancel b: the next chunk boundary retires its slot and pages
    b.cancel()
    n_b = len(b.tokens)

    # stream the rest of c: iterating the handle drives step(); its
    # admission happened mid-run, into a slot a or b freed
    streamed = list(c)
    dt = time.time() - t0
    print(f"req {c.uid} admitted mid-run → slot {c.slot}, "
          f"streamed {streamed}")
    assert streamed == c.tokens and len(streamed) == 6
    assert b.status is RequestStatus.CANCELLED
    assert len(b.tokens) == n_b, "cancelled request emitted after cancel"
    assert engine._backend.free_pages and a.status is RequestStatus.DONE
    print(f"served {len(engine.finished)} requests "
          f"({engine.sync_count} host syncs) in {dt:.1f}s")
    print("ok")
    return {"a": a.tokens, "b": b.tokens, "c": streamed,
            "syncs": engine.sync_count}


if __name__ == "__main__":
    main()
