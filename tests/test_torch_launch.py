"""The port's serve launcher (``python -m repro_torch.launch.serve``)
against the JAX package's (``repro.launch.serve``), on the CPU.

Each case runs the JAX launcher's ``main`` (its elastic mesh replaced by
a 1x1 mesh with Auto axes: jax 0.9's default Explicit axes are refused
by the JAX engine) and the port's ``main`` with the same flags and
``--reduced --device cpu``.  The JAX launcher draws its weights from
``--seed``; the port restores the same weights, carried over by
``convert.params_from_numpy``, from a checkpoint written by the port's
``CheckpointManager`` (``--checkpoint-dir``).  Both feed their engines
the launcher's submit loop (prompts from ``np.random.default_rng(seed)``)
and print one JSON report: every field but the wall-clock ones (wall
time, tok/s, TTFT) must be equal, and the port's keys are the JAX
report's, its robustness counters included (``robust`` bounds the queue
so that two requests are rejected, and gives every request a deadline
no serve reaches).  One JAX launch per case.
"""

import contextlib
import io
import json
import os
import sys

import jax
import pytest
import torch

from repro import configs as JC
from repro import models as JM
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serving.chaos import ChaosConfig
from test_torch_model import flatten, jax_mesh

ARCH = "qwen3-0.6b"
BASE = ["--arch", ARCH, "--reduced", "--requests", "6", "--slots", "2",
        "--max-new", "8", "--decode-chunk", "4"]
CASES = {
    "mono": [],
    "paged-prefix": ["--page-size", "16", "--prefix-cache",
                     "--shared-prefix", "16", "--prompt-len", "16"],
    "spec": ["--spec-k", "3"],
    "robust": ["--max-queue", "4", "--deadline-ms", "600000"],
}
#: the JAX report's robustness counters (ROADMAP queue 1 item 12a)
ROBUSTNESS = {"timeouts", "rejections", "preemptions", "numeric_faults",
              "kernel_failures", "fetch_errors", "degraded",
              "degraded_recoveries"}
#: items 12a's and 12b's flags, served since: each case of them in
#: ``test_unported_flags_raise`` runs a short serve and checks what it is
#: reported by
SERVED = {"--max-queue": "rejections", "--deadline-ms": "timeouts",
          "--supervise": "restarts", "--journal": "journal",
          "--snapshot-dir": "restarts", "--snapshot-every": "restarts",
          "--watchdog-ms": "restarts"}
#: item 12b's flags that name a path: the case puts it under ``tmp_path``
PATHS = {"--journal", "--snapshot-dir"}
#: wall-clock fields: the only ones allowed to differ
TIMED = {"wall_s", "tok_per_s", "ttft_p50_ms"}


def run_main(main, argv=None):
    """``main(argv)``'s printed lines and its exit code."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main() if argv is None else main(argv)
    return buf.getvalue().strip().splitlines(), rc


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX launcher's weights (``init_model`` at seed 0) in a port
    checkpoint, written as ``{"params": ...}`` at step 7."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    cfg = JC._module(ARCH).reduced()
    with jax_mesh():
        jp = JM.init_model(jax.random.key(0), cfg)
    CheckpointManager(d).save(
        7, {"params": params_from_numpy(flatten(jp), "cpu")}, blocking=True)
    return d


@pytest.fixture(scope="module", params=sorted(CASES))
def reports(request, checkpoint):
    """(JAX report, port report, port's printed lines) of one case."""
    flags = BASE + CASES[request.param]
    mp = pytest.MonkeyPatch()
    mp.setattr(jmesh, "make_elastic_mesh", lambda **kw: jax_mesh())
    mp.setattr(sys, "argv", ["serve"] + flags)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jlines, jrc = run_main(jserve.main)
        tlines, trc = run_main(tserve.main, flags + [
            "--device", "cpu", "--checkpoint-dir", checkpoint])
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    assert jrc == trc == 0
    return json.loads(jlines[-1]), json.loads(tlines[-1]), tlines


def test_report_keys_are_the_jax_keys_but_robustness(reports):
    """The keys are the JAX report's, the robustness counters included
    (the test's name is kept from when they were left out)."""
    jrep, trep, _ = reports
    assert ROBUSTNESS <= set(jrep)
    assert set(trep) == set(jrep)


def test_report_matches_jax(reports):
    """Every deterministic field: tokens, syncs, prefills, KV bytes and,
    per case, the pages, the prefix counters and speculation's drafted /
    accepted tokens."""
    jrep, trep, _ = reports
    for key in sorted(set(trep) - TIMED):
        assert trep[key] == jrep[key], key
    assert trep["generated_tokens"] > 0 and trep["host_syncs"] > 0


def test_restores_the_checkpoint(reports):
    *_, lines = reports
    assert lines[0] == "restored checkpoint step 7"


@pytest.mark.parametrize("flags,item", [
    (["--dry-run", "--model-parallel", "2"], "item 13"),
    (["--model-parallel", "2"], "item 13"), (["--devices", "8"], "item 13"),
    (["--max-queue", "4"], "item 12"), (["--deadline-ms", "50"], "item 12"),
    (["--supervise"], "item 12"), (["--journal", "wal.jsonl"], "item 12"),
    (["--snapshot-dir", "snap"], "item 12"),
    (["--snapshot-every", "2"], "item 12"),
    (["--watchdog-ms", "1000"], "item 12"),
])
def test_unported_flags_raise(flags, item, capsys, tmp_path, monkeypatch):
    """A flag of unported work raises before any model is built, naming
    the ROADMAP item that ports it; its default value is accepted.  The
    flags of items 12a and 12b, served now, run a short serve instead and
    are reported: 8 requests over a queue of 4 reject 4, a deadline ends
    every request timed out or done, ``--journal`` writes the journal,
    and ``--supervise`` (an error without ``--journal``) with any of the
    snapshot and watchdog flags serves under the supervisor; with a crash
    injected at tick 1, or a 3 s stall of every fetch from tick 2 under
    the 1 s watchdog, it restarts once and still delivers every token."""
    flags = [str(tmp_path / f) if f in ("wal.jsonl", "snap") else f
             for f in flags]
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu"] + flags
    if flags[0] not in SERVED:
        with pytest.raises(NotImplementedError, match=item):
            tserve.main(argv)
        return
    assert flags[0] not in PATHS or flags[1].startswith(str(tmp_path))
    if flags[0] == "--supervise":
        with pytest.raises(SystemExit):     # the journal is required
            tserve.main(argv)
        monkeypatch.setenv("REPRO_CHAOS_SEED", "0")
        monkeypatch.setenv("REPRO_CHAOS_RATE", "0")
        monkeypatch.setenv("REPRO_CHAOS_CRASH_TICK", "1")
    if flags[0] == "--watchdog-ms":     # a wedged device past the grace
        monkeypatch.setenv("REPRO_CHAOS_SEED", "0")
        monkeypatch.setattr(ChaosConfig, "from_env", classmethod(
            lambda cls: cls(seed=0, rate=0.0, hang_tick=2, hang_s=3.0)))
    if SERVED[flags[0]] == "restarts":
        argv += ["--journal", str(tmp_path / "sup.jsonl"), "--slots", "2"]
        argv += [] if flags[0] == "--supervise" else ["--supervise"]
        if flags[0] == "--snapshot-every":
            argv += ["--snapshot-dir", str(tmp_path / "snap")]
    capsys.readouterr()
    assert tserve.main(argv + ["--max-new", "2"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["requests"] == 8
    if flags[0] == "--max-queue":
        assert rep["rejections"] == 8 - int(flags[1])
        return
    assert rep["rejections"] == 0
    if flags[0] == "--deadline-ms":
        assert 0 <= rep["timeouts"] <= 8
        return
    assert rep["timeouts"] == 0 and rep["generated_tokens"] == 16
    if flags[0] == "--journal":
        assert "restarts" not in rep
        with open(flags[1]) as f:
            recs = [json.loads(line) for line in f]
        assert recs[0]["t"] == "cfg"
        assert sum(r["t"] == "submit" for r in recs) == 8
        assert sum(len(r["toks"]) for r in recs if r["t"] == "commit") == 16
        return
    assert rep["restarts"] == (flags[0] in ("--supervise", "--watchdog-ms"))
    assert set(rep["last_recovery"]) == (
        {"load_ms", "replay_ms", "pin_prefill_ms", "total_ms"}
        if rep["restarts"] else set())
    if flags[0] == "--snapshot-every":     # a snapshot every 2 of 4 ticks
        assert os.listdir(tmp_path / "snap")


def test_a_launch_refuses_an_earlier_serves_state(tmp_path, capsys):
    """Every launch is a fresh serve: a second launch on the first one's
    journal, supervised or not, or on the snapshot directory it left,
    exits with an error before any model is built, and leaves the first
    serve's files as they were."""
    jp, sd = tmp_path / "wal.jsonl", tmp_path / "snap"
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--slots", "2",
            "--max-new", "2"]
    supervised = ["--supervise", "--snapshot-dir", str(sd),
                  "--snapshot-every", "2"]
    assert tserve.main(base + ["--journal", str(jp)] + supervised) == 0
    journal, snaps = jp.read_bytes(), sorted(os.listdir(sd))
    assert journal and snaps
    for again in (["--journal", str(jp)],
                  ["--journal", str(jp)] + supervised,
                  ["--journal", str(tmp_path / "new.jsonl")] + supervised):
        capsys.readouterr()
        with pytest.raises(SystemExit):
            tserve.main(base + again)
        assert "earlier serve" in capsys.readouterr().err
    assert jp.read_bytes() == journal and sorted(os.listdir(sd)) == snaps
    assert not (tmp_path / "new.jsonl").exists()


def test_dry_run_reports_on_meta(capsys):
    """``--dry-run`` builds nothing: it runs the per-slot prefill and one
    decode chunk on ``meta`` and prints their peaks and FLOPs, the param
    and cache bytes and the plan rows (here of the reduced config)."""
    from repro_torch import configs as C
    from repro_torch import models as MZ
    from repro_torch.launch.dryrun import tree_bytes
    assert tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--dry-run", "--slots", "2", "--max-len", "64",
                        "--decode-chunk", "4"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = C.get_reduced(ARCH)
    assert rep["dry_run"] and rep["arch"] == cfg.name
    assert rep["param_bytes_global"] == tree_bytes(MZ.abstract_model(cfg))
    assert rep["cache_bytes_global"] == tree_bytes(MZ.abstract_cache(
        cfg, 2, 64, page_size=16, num_pages=rep["pool_pages"]))
    assert rep["page_size"] == 16 and rep["pool_pages"] == 2 * 64 // 16
    for name, calls in (("prefill_slot", "flash_attention"),
                        ("decode_chunk", "paged_attention")):
        prog = rep["programs"][name]
        mem = prog["memory"]
        assert prog["flops"] > 0 and prog["kernel_calls"][calls] > 0
        assert mem["peak_live_bytes"] >= mem["entry_bytes"] >= \
            rep["param_bytes_global"] + rep["cache_bytes_global"]
    assert rep["programs"]["decode_chunk"]["kernel_calls"][
        "paged_attention"] == 4 * cfg.n_layers
    assert rep["plan_rows"] == {"prefill": 0, "decode": 0}    # dense


def test_defaults_run_on_the_card():
    """Without ``--device`` the launcher asks for the card, and without
    one it raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", ARCH, "--reduced"])
