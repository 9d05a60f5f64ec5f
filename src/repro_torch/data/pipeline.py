"""Deterministic synthetic data, host-sharded and stateless — the JAX
package's ``data/pipeline.py`` for the port.

  * **Stateless**: a batch is a pure function of ``(seed, step,
    host_id)``.  It is drawn on the host from CPU ``torch.Generator``\\ s
    seeded from those three numbers and then moved to the device, so the
    CPU and the card see the same batch and a restart replays the stream
    with no iterator state to checkpoint.
  * **Host-sharded**: each host draws its slice of the global batch.
  * **Learnable**: tokens follow the JAX stream's structure over ``v =
    min(vocab, 4096)`` active tokens: each token is the hashed transition
    ``(a·t + b) mod v`` of the one before (``a = 1103515245 mod v``,
    ``b = 12345 mod v``), except with probability 0.15, where it is
    ``(t·48271 + 11) mod v``.  The bits are not JAX's (its batches come
    from threefry), so tests that compare the two feed both the same
    numpy batches.

Batch layouts match ``models`` conventions:
  lm/hybrid: {"tokens" (B, L) int32, "labels" (B, L)}, labels the
             stream shifted by one
  embeds   : {"embeds" (B, L, d) bf16, "labels" (B, L)}
  encdec   : {"src" (B, Ls, d) bf16, "tokens" (B, Lt), "labels" (B, Lt)}

``class_data`` emits the CNN benches' classification batches, a copy of
the JAX function (numpy, bit-equal).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import ModelConfig

ACTIVE_VOCAB = 4096
NOISE = 0.15


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    src_len: int = 0               # encdec source length (0 → seq_len)
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(
                f"global_batch {self.global_batch} % n_hosts "
                f"{self.n_hosts} != 0")
        return self.global_batch // self.n_hosts


def _generator(*idx: int) -> torch.Generator:
    """A CPU generator seeded from ``idx`` (non-negative ints)."""
    seed = np.random.SeedSequence(idx).generate_state(1, np.uint64)[0]
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


def active_vocab(vocab: int) -> int:
    return min(vocab, ACTIVE_VOCAB)


def transition(t, vocab: int):
    """The stream's deterministic successor of token(s) ``t``: ``(a·t +
    b) mod v``."""
    v = active_vocab(vocab)
    return (1103515245 % v * t + 12345 % v) % v


def _markov_tokens(gen: torch.Generator, batch: int, length: int,
                   vocab: int) -> torch.Tensor:
    """``(batch, length)`` int32 tokens: a random start, then each token
    the transition of the one before or, where the noise draw hits, its
    hashed replacement."""
    v = active_vocab(vocab)
    t = torch.randint(0, v, (batch,), generator=gen).numpy()
    noise = (torch.rand((batch, length), generator=gen) < NOISE).numpy()
    out = np.empty((batch, length), np.int64)
    for i in range(length):
        t = np.where(noise[:, i], (t * 48271 + 11) % v, transition(t, vocab))
        out[:, i] = t
    return torch.from_numpy(out.astype(np.int32))


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The batch for ``step`` on this host, on ``device``."""
    device = resolve_device(device)
    B, L = dcfg.host_batch, dcfg.seq_len
    kt = _generator(dcfg.seed, step, dcfg.host_id, 0)
    ks = _generator(dcfg.seed, step, dcfg.host_id, 1)

    def normal(shape):
        return torch.randn(shape, generator=ks).to(torch.bfloat16)

    if cfg.is_encoder_decoder:
        stream = _markov_tokens(kt, B, L + 1, cfg.vocab_size)
        batch = {"src": normal((B, dcfg.src_len or L, cfg.d_model)),
                 "tokens": stream[:, :-1], "labels": stream[:, 1:]}
    elif cfg.input_mode == "embeds":
        batch = {"embeds": normal((B, L, cfg.d_model)),
                 "labels": _markov_tokens(kt, B, L, cfg.vocab_size)}
    else:
        stream = _markov_tokens(kt, B, L + 1, cfg.vocab_size)
        batch = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    return {k: v.contiguous().to(device) for k, v in batch.items()}


def batch_for(cfg: ModelConfig, batch: int, seq: int, step: int = 0,
              seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    return make_batch(cfg, DataConfig(seed=seed, global_batch=batch,
                                      seq_len=seq), step, device)


# ---------------------------------------------------------------------------
# Classification data (CNN / TinyML benches)
# ---------------------------------------------------------------------------

def class_data(seed: int, n: int, shape: Tuple[int, ...], n_classes: int,
               separation: float = 3.0, coarse: int = 8
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images: x = mu_class + noise, the class
    means a coarse random pattern upsampled ``coarse``× (smooth templates
    small CNNs learn in a few hundred steps)."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    ch, cw = max(h // coarse, 1), max(w // coarse, 1)
    mus_c = rng.normal(size=(n_classes, ch, cw, c)).astype(np.float32)
    mus = np.repeat(np.repeat(mus_c, -(-h // ch), axis=1),
                    -(-w // cw), axis=2)[:, :h, :w, :]
    mus *= separation / np.sqrt(ch * cw * c)
    y = rng.integers(0, n_classes, size=n)
    x = mus[y] + rng.normal(size=(n, *shape)).astype(np.float32) * 0.3
    return x.astype(np.float32), y.astype(np.int32)
