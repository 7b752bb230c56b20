"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``) on the same inputs, on the CPU, at small sizes:

- ``scaling_study``: the same printed tables, line for line;
- ``comm_v2_tour`` and ``rma_tour``: each ``prog`` under its package's
  ``run_processes`` at one fixed eager threshold (the examples' own
  ``"auto"`` probes a timing); the deterministic reports are equal, the
  ``rma_*`` bytes a bucket included;
- ``cmpi_pingpong`` at ``--iters 3``: the same keys per size as the
  reference's ``prog``, and every message byte-exact, TCP included
  (times are not compared);
- ``serve_decode`` and ``quickstart`` with the JAX package's ``lm.init``
  weights carried across, in f32 compute: the same greedy tokens, and
  the ``run_training`` loss history within ``HISTORY_RTOL``;
- the README's runnable block of the port, through
  ``tools/run_doc_snippets.py``.

The multi-process runs go through one subprocess, one run at a time.
"""
import dataclasses
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import examples.quickstart as ref_quickstart  # noqa: E402
import examples.scaling_study as ref_scaling  # noqa: E402
import examples.serve_decode as ref_serve_decode  # noqa: E402
import chip_smoke  # noqa: E402
import examples_torch.comm_v2_tour as tour  # noqa: E402
import examples_torch.quickstart as quickstart  # noqa: E402
import examples_torch.scaling_study as scaling  # noqa: E402
import examples_torch.serve_decode as serve_decode  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
import repro.launch.serve as ref_launch_serve  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_train.py's bound on run_training's history (f32
# compute, the frameworks differ only in summation order)
HISTORY_RTOL = 1e-5
EAGER_THRESHOLD = 4096        # one threshold for both packages' tours
PINGPONG_ITERS = 3

_BOTH_PACKAGES = r"""
import pickle, sys
root, out = sys.argv[1], sys.argv[2]
sys.path[:0] = [root + "/src", root]
import repro.core as REF
import repro_torch.core as PORT
import examples.cmpi_pingpong as ref_pp
import examples.comm_v2_tour as ref_tour
import examples.rma_tour as ref_rma
import examples_torch.cmpi_pingpong as pp
import examples_torch.comm_v2_tour as tour
import examples_torch.rma_tour as rma

thr, iters = int(sys.argv[3]), int(sys.argv[4])
res = {}
# the tours at their mains' pools and timeouts, one fixed threshold
for name, ref, port, kw in (
        ("tour", ref_tour, tour, {"eager_threshold": thr}),
        ("rma", ref_rma, rma, {})):
    res[name] = {
        "ref": REF.run_processes(4, ref.prog, pool_bytes=128 << 20,
                                 timeout=300, **kw),
        "port": PORT.run_processes(4, port.prog, pool_bytes=128 << 20,
                                   timeout=300, device="cpu", **kw)}
ref_pp.ITERS = iters                 # the forked ranks see it
res["pingpong"] = {
    "ref": REF.run_processes(2, ref_pp.prog, pool_bytes=64 << 20,
                             cell_size=65536),
    "port": pp.main(["--device", "cpu", "--iters", str(iters)])}
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The multi-process examples of both packages, run in one
    subprocess (``run_processes`` spawns the port's ranks)."""
    out = tmp_path_factory.mktemp("examples") / "procs.pkl"
    run = subprocess.run(
        [sys.executable, "-c", _BOTH_PACKAGES, str(ROOT), str(out),
         str(EAGER_THRESHOLD), str(PINGPONG_ITERS)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_scaling_study_prints_the_reference_output(capsys, monkeypatch):
    nodes = ["--nodes", "2", "4"]
    monkeypatch.setattr(sys, "argv", ["scaling_study.py", *nodes])
    ref_scaling.main()
    want = capsys.readouterr().out
    got = scaling.main(nodes)
    assert capsys.readouterr().out.splitlines() == want.splitlines()
    assert sorted(got) == ["CG", "miniAMR"]
    assert all(sorted(v) == [2, 4] for v in got.values())


def test_comm_v2_tour_matches_the_reference(procs):
    """Equal reports. Which side of a rendezvous copies a 128 KiB ring
    chunk depends, in both packages, on whether the receive was posted
    before the send claimed it, so each rank's ``allreduce_copied``
    varies from run to run by whole chunks; their sum over the ranks
    does not. Its rendezvous part, the same at any eager threshold, is
    what ``chip_smoke.py`` holds the card's run to."""
    ref, port = procs["tour"]["ref"], procs["tour"]["port"]
    copied = [sum(r["allreduce_copied"] for r in rs) for rs in (ref, port)]
    assert copied[1] == copied[0]
    assert sum(v for r in port for k, v in r["allreduce_paths"].items()
               if k.startswith("rndv_")) == chip_smoke.tour_ring_bytes(tour)
    chunk = 8 * tour.VEC // tour.N
    for r, (a, b) in enumerate(zip(ref, port)):
        assert b["threshold"] == a["threshold"] == (EAGER_THRESHOLD, None)
        assert (b["allreduce_copied"] - a["allreduce_copied"]) % chunk == 0
        for key in ("dup_msg", "slots_stable"):
            assert b[key] == a[key], (r, key)
        assert (b["row"][0], list(b["row"][1]), b["row"][2]) == \
            (a["row"][0], list(a["row"][1]), a["row"][2])
        assert b["allreduce_ok"] and b["hier_equals_ring"] \
            and b["persistent_ok"] and b["slots_stable"]
        assert b["launches"] == 0            # no kernel on the CPU


def test_rma_tour_matches_the_reference(procs):
    ref, port = procs["rma"]["ref"], procs["rma"]["port"]
    consumers = 0
    for r, (a, b) in enumerate(zip(ref, port)):
        assert {k: v for k, v in b.items() if k != "launches"} == a, r
        consumers += "recv_copies" in b
        assert b.get("recv_copies", 0) == 0
    assert consumers == 2


def test_cmpi_pingpong_keys_and_bytes(procs):
    ref, port = procs["pingpong"]["ref"], procs["pingpong"]["port"]
    for a, b in zip(ref, port["ranks"]):
        assert {k for k in b if isinstance(k, tuple)} == set(a)
        assert set(b["exact"]) == set(a) and all(b["exact"].values())
    sizes = sorted({s for _, s in ref[0]})
    assert set(port["exact"]) == {f"{c}:{s}" for c in (
        "two", "pers", "one", "tcp") for s in sizes}
    assert all(port["exact"].values())
    assert {c: sorted(v) for c, v in port["us"].items()} == {
        c: sizes for c in ("two", "pers", "one", "tcp")}


def _f32(get_config):
    """``get_config`` with f32 compute: the frameworks then differ only
    in summation order."""
    return lambda arch: dataclasses.replace(get_config(arch),
                                            compute_dtype="float32")


def _jax_weights(monkeypatch, arch):
    """Make the port's ``lm.init`` (as the examples reach it) give the
    JAX package's ``lm.init`` weights of ``arch``'s reduced config, seed
    0, a fresh copy per call."""
    tree = jax.tree.map(np.asarray, jlm.init(
        ref_configs.get_config(arch).reduced(), jax.random.key(0)))
    tp = lm.params_from_numpy(port_configs.get_config(arch).reduced(), tree,
                              device="cpu")
    monkeypatch.setattr(lm, "init", lambda cfg, seed=0, device="cuda":
                        lm._tree_map(lambda t: t.clone().to(device), tp))


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` so that its results are kept."""
    seen = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        seen.append(fn(*a, **k))
        return seen[-1]
    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_serve_decode_greedy_tokens_match_the_reference(monkeypatch):
    monkeypatch.setattr(ref_configs, "get_config",
                        _f32(ref_configs.get_config))
    monkeypatch.setattr(port_configs, "get_config",
                        _f32(port_configs.get_config))
    _jax_weights(monkeypatch, "smollm-135m")
    want = _record(monkeypatch, ref_launch_serve, "serve_batch")
    monkeypatch.setattr(sys, "argv", ["serve_decode.py"])
    ref_serve_decode.main()
    got = serve_decode.main(["--device", "cpu"])
    assert np.asarray(got["tokens"]).shape == (4, 24)
    np.testing.assert_array_equal(got["tokens"], want[0]["tokens"])


def test_serve_decode_ranks_on_the_cpu():
    """``--ranks 3``: the router and two workers finish every session
    with no bad checksum; no kernel runs on the CPU."""
    router = serve_decode.main(["--ranks", "3", "--sessions", "6",
                                "--device", "cpu"])
    assert router["sessions"] == 6 and router["bad_checksums"] == 0
    assert router["stats_tokens"] == router["tokens"] > 0
    assert router["launches_by_rank"] == [0, 0, 0]


def test_quickstart_history_matches_the_reference(monkeypatch):
    monkeypatch.setattr(ref_quickstart, "get_config",
                        _f32(ref_quickstart.get_config))
    monkeypatch.setattr(quickstart, "get_config",
                        _f32(quickstart.get_config))
    _jax_weights(monkeypatch, "smollm-135m")
    want = _record(monkeypatch, ref_quickstart, "run_training")
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--steps", "4"])
    ref_quickstart.main()
    got = quickstart.main(["--steps", "4", "--device", "cpu"])
    assert len(got["history"]) == 4 and want[1]["history"] == []
    np.testing.assert_allclose(got["history"], want[0]["history"],
                               rtol=HISTORY_RTOL)
    assert got["restart"] == {"saved_step": 4, "steps_rerun": 0,
                              "params_equal": True}


def test_readme_port_block_runs(tmp_path):
    """The port section of README.md, cut out, through the doc-snippet
    runner: its one runnable block passes, the fragments are skipped."""
    text = (ROOT / "README.md").read_text()
    start = text.index("## PyTorch/CUDA port")
    end = text.index("\n## ", start + 1)
    doc = tmp_path / "port.md"
    doc.write_text(text[start:end])
    run = subprocess.run(
        [sys.executable, "tools/run_doc_snippets.py", "--timeout", "120",
         str(doc)], cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "1 block(s) ran, 2 skipped, 0 failure(s)" in run.stdout
