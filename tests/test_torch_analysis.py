"""The port's analysis passes against the JAX package's: the schedule
verifier over ``repro_torch.core.sched`` (equal reports over the whole
compiler matrix, each seeded defect flagged with the reference's code,
the ``compile_schedule(verify=True)`` hook), the protocol linter (the
reference's inputs give the same findings; the port's ``core/`` lints
clean under the widened LP001), the roofline arithmetic of ``hlo``
(exact where the arithmetic is the same) and its dispatch counter, and
the pre-v2 shims of ``repro_torch.core``."""
import collections
import dataclasses
import importlib.util
import inspect
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.analysis import hlo as ref_H  # noqa: E402
from repro.analysis import lint_protocol as ref_lint  # noqa: E402
from repro.analysis import verify as ref_V  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import hlo as H  # noqa: E402
from repro_torch.analysis import lint_protocol as lint  # noqa: E402
from repro_torch.analysis import verify as V  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.sched import (MAX_ROUNDS, BufRef,  # noqa: E402
                                    RecvOp, Schedule,
                                    ScheduleInvariantError, SendOp,
                                    compile_schedule)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402

TESTS = Path(__file__).resolve().parent
MAX_N = 16                   # tests/test_verify.py's sweep


# --------------------------------------------------------------------------
# the verifier
# --------------------------------------------------------------------------

def _reports(mod, n: int) -> list:
    out = []
    for cfg in mod.iter_matrix(MAX_N):
        if cfg["n"] != n:
            continue
        cfg = dict(cfg)
        kind, size = cfg.pop("kind"), cfg.pop("n")
        rep = mod.verify_config(kind, size, **cfg)
        out.append((rep.config, sorted(collections.Counter(
            f.code for f in rep.findings).items())))
    return out


def test_iter_matrix_equals_the_reference():
    assert list(V.iter_matrix(MAX_N)) == list(ref_V.iter_matrix(MAX_N))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 12, 16])
def test_verify_config_reports_equal_the_reference(n):
    got = _reports(V, n)
    assert got == _reports(ref_V, n)
    assert got and all(codes == [] for _, codes in got)


def test_sweep_counts_equal_the_reference():
    count, bad = V.sweep(6)
    ref_count, ref_bad = ref_V.sweep(6)
    assert (count, len(bad)) == (ref_count, len(ref_bad)) and not bad


def _two_rank(pkg_schedule, nodes0, nodes1, *, rounds):
    out = []
    for rank, nodes in ((0, nodes0), (1, nodes1)):
        s = pkg_schedule("handmade", 2, rank)
        for nd in nodes:
            s._add(nd)
        s.rounds = rounds
        out.append(s)
    return out


def _defects(V, sched):
    """The seeded defects of tests/test_verify.py, built from one
    package's verifier (``V``) and schedule IR (``sched``): name ->
    (schedules, verify_schedules kwargs)."""
    B, Rv, Sd = sched.BufRef, sched.RecvOp, sched.SendOp

    def orphan():
        s = V.compile_group("bcast", 2, nbytes=64)
        s[1].nodes = [nd for nd in s[1].nodes if not isinstance(nd, Rv)]
        return s, {}

    def forward_dep():
        s = V.compile_group("allreduce_ring", 4, nbytes=512, itemsize=8)
        s[0].nodes[0].deps = (2,)
        return s, {}

    def swapped_tags():
        s = V.compile_group("allgather_bruck", 4, nbytes=256)
        sends = [nd for nd in s[0].nodes if isinstance(nd, Sd)]
        sends[0].round, sends[1].round = sends[1].round, sends[0].round
        return s, {}

    def truncated():
        s = V.compile_group("allreduce_rd", 2, nbytes=256, itemsize=8)
        snd = next(nd for nd in s[0].nodes if isinstance(nd, Sd))
        snd.buf = B(snd.buf.slot, snd.buf.off, 128)
        return s, {}

    def hazard():
        return _two_rank(sched.Schedule, [
            Rv(deps=(), peer=1, buf=B(0, 0, 64), round=0),
            Rv(deps=(), peer=1, buf=B(0, 32, 64), round=1)], [
            Sd(deps=(), peer=0, buf=B(0, 0, 64), round=0),
            Sd(deps=(0,), peer=0, buf=B(0, 32, 64), round=1)],
            rounds=2), {}

    def depth():
        return (V.compile_group("allreduce_ring", 4, nbytes=512,
                                itemsize=8), {"matchbox_capacity": 1})

    def cycle():
        return _two_rank(sched.Schedule, [
            Rv(deps=(), peer=1, buf=B(1, 0, 64), round=0),
            Sd(deps=(0,), peer=1, buf=B(0, 0, 64), round=1)], [
            Rv(deps=(), peer=0, buf=B(1, 0, 64), round=1),
            Sd(deps=(0,), peer=0, buf=B(0, 0, 64), round=0)],
            rounds=2), {}

    def unchained():
        return _two_rank(sched.Schedule, [
            Sd(deps=(), peer=1, buf=B(0, 0, 64), round=0),
            Sd(deps=(), peer=1, buf=B(0, 64, 64), round=1)], [
            Rv(deps=(), peer=0, buf=B(1, 0, 64), round=0),
            Rv(deps=(), peer=0, buf=B(2, 0, 64), round=1)],
            rounds=2), {}

    def duplicate():
        return _two_rank(sched.Schedule, [
            Sd(deps=(), peer=1, buf=B(0, 0, 64), round=0),
            Sd(deps=(0,), peer=1, buf=B(0, 0, 64), round=0)], [
            Rv(deps=(), peer=0, buf=B(1, 0, 64), round=0)],
            rounds=1), {}

    def tag_window():
        s = V.compile_group("bcast", 2, nbytes=64)
        for x in s:
            x.rounds = sched.MAX_ROUNDS + 1
        return s, {}

    def rounds():
        s = V.compile_group("bcast", 2, nbytes=64)
        s[1].rounds += 1
        return s, {}

    return {"orphan send": (orphan, "orphan-send"),
            "forward dep": (forward_dep, "invariant"),
            "swapped tags": (swapped_tags, "orphan-recv"),
            "truncated send": (truncated, "size-mismatch"),
            "hazard": (hazard, "buffer-hazard"),
            "depth overflow": (depth, "depth-overflow"),
            "cross-rank cycle": (cycle, "deadlock"),
            "unchained same-slot sends": (unchained, "unchained-send"),
            "duplicate round": (duplicate, "duplicate-match"),
            "tag window": (tag_window, "tag-window"),
            "rounds disagreement": (rounds, "rounds-mismatch")}


DEFECTS = list(_defects(V, __import__("repro_torch.core.sched",
                                      fromlist=["x"])))


@pytest.mark.parametrize("defect", DEFECTS)
def test_seeded_defect_flagged_as_the_reference(defect):
    import repro.core.sched as ref_sched
    import repro_torch.core.sched as port_sched
    make, code = _defects(V, port_sched)[defect]
    ref_make, _ = _defects(ref_V, ref_sched)[defect]
    scheds, kw = make()
    ref_scheds, ref_kw = ref_make()
    got = V.verify_schedules(scheds, **kw)
    want = ref_V.verify_schedules(ref_scheds, **ref_kw)
    assert code in got.codes()
    assert [(f.code, f.rank, f.node) for f in got.findings] == \
        [(f.code, f.rank, f.node) for f in want.findings]
    with pytest.raises(ScheduleInvariantError, match=code):
        got.raise_if_failed()


def test_verify_hook_accepts_clean_config():
    sched = compile_schedule(V._CompileView(4, 1), "allreduce_ring", 512,
                             8, chunk_bytes=128, verify=True)
    assert isinstance(sched, Schedule) and sched.rounds <= MAX_ROUNDS


def test_verify_hook_raises_on_a_broken_compiler(monkeypatch):
    """A compiler that drops rank 1's receives: the hook compiles every
    rank through it and raises the verifier's finding."""
    import repro_torch.core.sched as port_sched
    real = port_sched._COMPILERS["bcast"]

    def broken(n, rank, *a):
        s = real(n, rank, *a)
        if rank == 1:
            s.nodes = [nd for nd in s.nodes if not isinstance(nd, RecvOp)]
        return s

    monkeypatch.setitem(port_sched._COMPILERS, "bcast", broken)
    with pytest.raises(ScheduleInvariantError, match="orphan-send"):
        compile_schedule(V._CompileView(2, 0), "bcast", 64, verify=True)
    assert compile_schedule(V._CompileView(2, 0), "bcast", 64).nodes


def test_verify_cli_sweep(capsys):
    assert V.main(["--max-n", "4"]) == 0
    out = capsys.readouterr().out
    assert ref_V.main(["--max-n", "4"]) == 0
    assert out == capsys.readouterr().out and "0 failing" in out


def test_verify_public_names_equal_the_reference():
    """The verifier's public names are the reference's."""
    assert V.__all__ == ref_V.__all__
    assert isinstance(BufRef(0, 0, 1), BufRef) and SendOp and RecvOp


# --------------------------------------------------------------------------
# the protocol linter
# --------------------------------------------------------------------------

def _reference_lint_inputs() -> list:
    """Every ``lint_sources`` input of tests/test_lint_protocol.py, taken
    by running its tests with a recorder in place of ``lint_sources``."""
    spec = importlib.util.spec_from_file_location(
        "_ref_lint_tests", TESTS / "test_lint_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []

    def record(sources):
        seen.append(dict(sources))
        return ref_lint.lint_sources(sources)

    mod.lint_sources = record
    for name in dir(mod):
        cls = getattr(mod, name)
        if not (isinstance(cls, type) and name.startswith("Test")) \
                or name == "TestShippedCore":
            continue
        for meth in dir(cls):
            fn = getattr(cls(), meth)
            # the tests that take only self feed lint_sources; the CLI
            # ones (fixtures) lint the reference's own tree
            if meth.startswith("test_") and not inspect.signature(
                    fn).parameters:
                fn()
    return seen


REF_LINT_INPUTS = _reference_lint_inputs()


def test_reference_lint_inputs_found():
    assert len(REF_LINT_INPUTS) >= 25


@pytest.mark.parametrize("i", range(len(REF_LINT_INPUTS)))
def test_lint_findings_equal_the_reference(i):
    src = REF_LINT_INPUTS[i]
    got = [(f.rule, f.path, f.line) for f in lint.lint_sources(src)]
    want = [(f.rule, f.path, f.line) for f in ref_lint.lint_sources(src)]
    assert got == want


def test_port_core_lints_clean():
    findings = lint.lint_paths([lint._default_target()])
    assert findings == [], "\n".join(map(str, findings))
    assert lint._default_target().parts[-2:] == ("repro_torch", "core")
    assert lint.main([]) == 0


DEVICE_SRC = ("class Comm:\n"
              "    def fill(self, pb, n):\n"
              "        return self.arena.pool.device_view(pb.offset, n)\n")


@pytest.mark.parametrize("call", [
    "self.arena.pool.device_view(0, 8)", "pb._comm.arena.pool.tensor_view("
    "0, 8, dev)", "self.backing.write_device(0, t)",
    "self.pool.read_device(0, t)", "env.pool.device_ptr(0, 8)",
    "scratch.device_view(16, 8)"])
def test_device_side_access_is_lp001(call):
    """The one place the port's LP001 is wider than the reference's: the
    pool's device-side primitives, on a ``.pool``/``.backing`` chain or
    a name bound to a pool object (``scratch`` below)."""
    src = ("from x import LocalPool\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._cell_scratch = LocalPool(64, 'cuda')\n"
           "    def f(self, pb, env, dev, t):\n"
           "        scratch = self._cell_scratch\n"
           f"        return {call}\n")
    fs = lint.lint_sources({"x/comm.py": src})
    assert [(f.rule, f.line) for f in fs] == [("LP001", 7)]
    assert ref_lint.lint_sources({"x/comm.py": src}) == []
    waived = src.replace(f"{call}\n", f"{call}  # lint: raw-ok (test)\n")
    assert lint.lint_sources({"x/comm.py": waived}) == []
    assert lint.lint_sources({"x/coherence.py": src}) == []


def test_device_view_of_a_tensor_is_not_lp001():
    src = "def f(t):\n    return t.device_view(0, 8)\n"
    assert lint.lint_sources({"x/comm.py": src}) == []
    assert [f.rule for f in lint.lint_sources(
        {"x/comm.py": DEVICE_SRC})] == ["LP001"]


# --------------------------------------------------------------------------
# hlo: the roofline arithmetic and the counter
# --------------------------------------------------------------------------

def test_constants_are_the_h100s():
    assert H.PEAK_FLOPS == 989e12 and H.HBM_BW == 3.35e12
    assert H.LINK_BW == pytest.approx(63.0e9, rel=1e-3)     # PCIe 5.0 x16
    assert H.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12, "float32": 67e12,
                                     "tf32": 495e12}


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "send"])
def test_ring_factors_equal_the_reference(kind):
    for s in (1, 2, 3, 16, 512):
        for rb in (0, 8, 1000, 1 << 30):
            assert H._wire_bytes(kind, rb, s) == ref_H._wire_bytes(kind, rb, s)


def test_roofline_equals_the_reference_under_the_same_constants(
        monkeypatch):
    for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_H, k, getattr(H, k))
    for args in ((1.1e11, 6.8e9, 0.0, 1.08e11), (3e13, 4e12, 2e11, 1e13),
                 (0.0, 0.0, 0.0, 0.0), (1e9, 1e12, 5e12, 1e9)):
        assert H.Roofline(*args).as_dict() == ref_H.Roofline(*args).as_dict()


@pytest.mark.parametrize("arch", list(REF_ARCHS))
def test_model_flops_equal_the_reference(arch):
    for shape in SHAPES:
        for chips in (1, 256, 512):
            assert H.model_flops(get_config(arch), SHAPES[shape], chips) \
                == ref_H.model_flops(ref_config(arch), REF_SHAPES[shape],
                                     chips)


def test_count_dot_flops_and_bytes():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    x, y = torch.randn(3, 8, 16), torch.randn(3, 16, 5)
    st = H.count(lambda: (a @ b, torch.bmm(x, y), a.t(), a.view(16, 8)))
    assert st.flops == 2 * 8 * 16 * 4 + 2 * 3 * 8 * 16 * 5
    # inputs plus outputs, f32; the transpose and view move nothing
    assert st.bytes_ == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * (
        3 * 8 * 16 + 3 * 16 * 5 + 3 * 8 * 5)
    assert st.dot_flops == {"mm(8, 4)": 1024.0, "bmm(3, 8, 5)": 3840.0}
    assert st.kernels == {} and st.total_wire_bytes == 0


def test_count_sees_the_backward():
    w = torch.randn(16, 4, requires_grad=True)
    a = torch.randn(8, 16)
    st = H.count(lambda: (a @ w).sum().backward())
    assert st.flops == 2 * (2 * 8 * 16 * 4)      # forward, and dW


def test_count_keeps_the_device_of_factory_ops():
    """A factory op names no tensor: its output is remembered only where
    it is a meta tensor, so a repeated one off the meta device stays
    there."""
    def f():
        a = torch.arange(8, dtype=torch.float32)
        b = torch.arange(8, dtype=torch.float32)
        return (a * b).sum()
    assert H.count(f).flops == 0
    assert f().item() == 140.0


def test_count_meta_matches_cpu():
    def f(dev):
        a = torch.ones(32, 64, device=dev)
        b = torch.ones(64, 16, device=dev)
        return lambda: torch.relu(a @ b).sum()
    cpu, meta = H.count(f("cpu")), H.count(f("meta"))
    assert (cpu.flops, cpu.bytes_) == (meta.flops, meta.bytes_)


def _flash_inputs(dev, s=64, d=32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, s, d, generator=g)
    k = torch.randn(2, 2, s, d, generator=g)
    v = torch.randn(2, 2, s, d, generator=g)
    return [t.to(dev) for t in (q, k, v)]


def test_flash_charges_the_causal_triangle_on_cpu_and_meta():
    want = fops.work(2, 4, 2, 64, 32, torch.float32)
    assert want == (4 * 2 * 4 * 32 * 64 * 65 // 2,
                    4 * 32 * 64 * 2 * (2 * 4 + 2 * 2))
    for dev in ("cpu", "meta"):
        q, k, v = _flash_inputs(dev)
        st = H.count(fops.flash_attention, q, k, v, causal=True)
        assert st.kernels == {"flash_attention": {
            "launches": 1, "flops": want[0], "bytes": want[1]}}
        # the plain version's ops are not counted on top
        assert (st.flops, st.bytes_) == want


def test_wkv6_charges_its_work_on_cpu_and_meta():
    want = wops.work(1, 2, 16, 8, torch.float32)
    assert want == (1 * 2 * 16 * (5 * 64 + 32),
                    1 * 2 * 16 * 8 * (3 * 4 + 8) + 2 * 8 * 4)
    assert wops.bwd_work(1, 2, 16, 8, "bfloat16") == (
        2 * 16 * (14 * 64 + 80), 2 * 16 * 8 * (12 + 12) + 2 * 2 * 8 * 4)
    g = torch.Generator().manual_seed(1)
    for dev in ("cpu", "meta"):
        r, k, v = (torch.randn(1, 2, 16, 8, generator=g).to(dev)
                   for _ in range(3))
        w = torch.rand(1, 2, 16, 8, generator=g).to(dev)
        u = torch.randn(2, 8, generator=g).to(dev)
        st = H.count(wops.wkv6, r, k, v, w, u)
        assert st.kernels["wkv6"] == {"launches": 1, "flops": want[0],
                                      "bytes": want[1]}
        assert (st.flops, st.bytes_) == want


def test_meta_kernels_run_under_autograd():
    """The meta route's kernels under autograd: the wkv6 backward is
    charged as the ``wkv6_bwd`` kernel, flash's backward is counted as
    the torch ops of ``kernels/flash_attention/bwd.py``."""
    q, k, v = (t.requires_grad_() for t in _flash_inputs("meta"))

    def step():
        fops.flash_attention(q, k, v).sum().backward()
    st = H.count(step)
    assert st.kernels["flash_attention"]["launches"] == 1
    assert st.flops > fops.work(2, 4, 2, 64, 32, torch.float32)[0]
    r, k2, v2, w = (torch.empty(1, 2, 16, 8, device="meta",
                                requires_grad=True) for _ in range(4))
    u = torch.empty(2, 8, device="meta", requires_grad=True)
    st = H.count(lambda: wops.wkv6(r, k2, v2, w, u).sum().backward())
    assert st.kernels["wkv6_bwd"] == {
        "launches": 1, "flops": wops.bwd_work(1, 2, 16, 8, r.dtype)[0],
        "bytes": wops.bwd_work(1, 2, 16, 8, r.dtype)[1]}
    assert r.grad is not None and r.grad.shape == r.shape


def test_bound_ms_reads_the_moved_formulas():
    """The bound of PERF.md's flash row at llama3-8b's 1 x 4096 bf16."""
    ms, by = H.bound_ms(*fops.work(1, 32, 8, 4096, 128, "bfloat16"),
                        "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(0.1390, abs=5e-5)


def test_record_collective_outside_count_is_a_no_op():
    H.record_collective("all-reduce", 8, 2, "data")
    assert kernels.COUNTERS == []


# --------------------------------------------------------------------------
# the pre-v2 shims
# --------------------------------------------------------------------------

SHIMS = list(ref_core._DEPRECATED)


@pytest.mark.parametrize("name", SHIMS)
def test_pre_v2_name_served_with_a_warning(name):
    with pytest.warns(DeprecationWarning, match=rf"repro_torch\.core\.{name}"):
        obj = getattr(port_core, name)
    module, attr, _ = port_core._DEPRECATED[name]
    assert obj is getattr(importlib.import_module(module), attr)
    assert module.replace("repro_torch", "repro") == \
        ref_core._DEPRECATED[name][0]
    assert name in dir(port_core)


def test_unknown_core_name_raises_attribute_error():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(AttributeError, match="no attribute"):
            port_core.not_a_name  # noqa: B018


def test_shim_names_equal_the_reference():
    assert sorted(port_core._DEPRECATED) == sorted(ref_core._DEPRECATED)
    assert dataclasses.is_dataclass(port_core.ProtocolStats)
