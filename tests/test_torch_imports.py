"""The port stands alone, and rejects what it does not run.

* Every module of ``fairify_tpu_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` blocked, and none imports ``jax`` or any ``fairify_tpu`` module.
* The numeric policy holds after import: no TF32 anywhere.
* Configurations the port once rejected run now, under the ids they had
  when they raised, and equal the JAX package or the port's other path;
  settings that change only timing (depth, retries) change no outcome; a
  CUDA entry point without CUDA raises.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "fairify_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The worlds here are small: torch's intra-op threads only contend with
    each other and with the other test workers.  One thread for this
    module, the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _is_forbidden(name: str) -> bool:
    return name in ("jax", "fairify_tpu") or name.startswith(("jax.", "fairify_tpu."))


def test_package_imports_with_jax_blocked():
    names = [name for name, _ in _modules()]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["h5py"] = None  # the card's machine has none
        for name in {names!r}:
            importlib.import_module(name)
        import chip_smoke
        from fairify_tpu_torch.ops import crown
        from fairify_tpu_torch.parallel import mesh
        from fairify_tpu_torch.verify import engine, pruning, smt, sweep
        from fairify_tpu_torch.ops import train_step
        from fairify_tpu_torch.models import train
        from fairify_tpu_torch.analysis import causal, experiment, hybrid, localize, repair
        from fairify_tpu_torch.models import export, synth
        from fairify_tpu_torch.ops import synth_step
        from fairify_tpu_torch.scripts import synthetic_models
        for mod, names in ((mesh, ("Mesh", "make_mesh", "submesh", "pad_to_multiple",
                                   "shard_parts", "replicated", "shard_map")),
                           (sweep, ("run_sweep", "SmtDrain", "verify_model")),
                           (smt, ("to_smtlib", "build_query", "decide_box_smt")),
                           (engine, ("role_certify", "split_certify_attack_submit")),
                           (pruning, ("sim_stats", "harsh_prune_grid")),
                           (crown, ("alpha_crown_output_bounds",)),
                           (train_step, ("bce_adam_step", "pair_adam_step",
                                         "pair_inconsistency", "bce_adam_step_plain",
                                         "pair_adam_step_plain", "pair_inconsistency_plain")),
                           (train, ("train_mlp",)),
                           (repair, ("masked_repair", "same_label_relabel_retrain",
                                     "counterexample_retrain", "neuron_gradient_masks")),
                           (localize, ("localize", "global_index_map")),
                           (hybrid, ("route_points", "hybrid_predict", "evaluate_hybrid")),
                           (causal, ("causal_discrimination", "discrimination_search")),
                           (experiment, ("run_experiment", "repair_success", "audit")),
                           (synth, ("GaussianCopula", "ColumnQuantizer", "ARColumnModel",
                                    "bootstrap_rows", "synthesize", "GENERATORS")),
                           (synth_step, ("Shape", "synth_step", "synth_draw", "synth_step_plain",
                                         "synth_draw_plain", "column_keys")),
                           (export, ("save_keras_h5",)),
                           (synthetic_models, ("main", "SLOT_BASE", "SLOT_OFFSET"))):
            missing = [n for n in names if not hasattr(mod, n)]
            assert not missing, (mod.__name__, missing)
        assert {{"role_certify", "sim_stats", "alpha_crown", "train_step", "fit_step",
                 "pair_step", "pair_inconsistency", "synth_step", "synth_draw"}} <= set(
            sweep.KERNELS)
        bad = [m for m in sys.modules if m == "fairify_tpu"
               or m.startswith("fairify_tpu.") or m == "jax" and sys.modules[m]]
        assert not bad, bad
        print("ok", len({names!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", [p for _, p in _modules()] + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, node.lineno, names)


def test_worker_and_loaders_import_without_torch():
    """The SMT worker's whole import chain and the loaders stand without
    torch, JAX, pandas and sklearn: a worker never initialises CUDA (its
    RLIMIT_AS cap would kill it), and the port needs neither pandas nor
    sklearn."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("torch", "jax", "pandas", "sklearn"):
            sys.modules[name] = None
        for name in ("fairify_tpu_torch.smt.worker", "fairify_tpu_torch.smt.protocol",
                     "fairify_tpu_torch.smt.brute", "fairify_tpu_torch.data.loaders"):
            importlib.import_module(name)
        from fairify_tpu_torch import smt
        assert "fairify_tpu_torch.smt.pool" not in sys.modules
        assert sorted(smt.__all__) == ["PoolConfig", "SmtPool", "SmtResult", "WorkerDied",
                                       "solve_box", "submit_box"]
        bad = [m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "pandas",
                                                            "sklearn", "fairify_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tf32_is_off_after_import():
    from fairify_tpu_torch.utils import num

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    num.check_policy()


def _cfg(tmp_path, **kw):
    from fairify_tpu_torch.verify import presets

    return presets.get("GC").with_(result_dir=str(tmp_path), **kw)


def _outcomes(tmp_path, tag, **kw):
    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.verify import sweep

    rep = sweep.verify_model(flagship_net(device="cpu"),
                             _cfg(tmp_path / tag, **dict(dict(grid_chunk=16), **kw)),
                             resume=False, device="cpu", partition_span=(0, 40))
    return ([(o.partition_id, o.verdict, o.pruned_acc, o.compressions) for o in rep.outcomes],
            rep.funnel["margin_hist"])


def _jax_outcomes(tmp_path, **kw):
    from __graft_entry__ import _flagship_net
    from fairify_tpu.verify import presets as jpresets
    from fairify_tpu.verify import sweep as jsweep

    cfg = jpresets.get("GC").with_(result_dir=str(tmp_path / "jax"), grid_chunk=16, **kw)
    rep = jsweep.verify_model(_flagship_net(), cfg, resume=False, partition_span=(0, 40))
    return ([(o.partition_id, o.verdict, o.pruned_acc, o.compressions) for o in rep.outcomes],
            rep.funnel["margin_hist"])


@pytest.mark.parametrize("field,value,item", [
    # The chunk loop (mega_chunks=0) is ported: the case now runs it and
    # requires the mega path's outcomes, launches aside.  The id is the one
    # it had when it raised.
    pytest.param("mega_chunks", 0, None, id="mega_chunks-0-K10"),
    # The exact-certify pass is ported: the case now runs it and requires
    # JAX's outcomes, compression columns included.  Its id is the one it
    # had when it raised.
    pytest.param("exact_certify_masks", True, "jax", id="exact_certify_masks-True-exact-certify"),
    # The runtime contracts (ROADMAP queue 1, item 4) are ported: each case
    # now runs and requires JAX's outcomes.  The ids are the ones they had
    # when they raised (the first two named item 7, the number the item had
    # before the ROADMAP was re-anchored).
    pytest.param("inject_faults", ("launch.decode:transient:1",), "jax",
                 id="inject_faults-value2-item 7"),
    pytest.param("integrity_recheck", 0.05, "jax", id="integrity_recheck-0.05-item 7"),
    # Settings with which the JAX package writes or changes an output (the
    # paths are taken under the test's directory, one per package).
    pytest.param("trace_out", "trace.jsonl", "jax", id="trace_out-trace.jsonl-item 4"),
    pytest.param("profile_dir", "prof", "jax", id="profile_dir-prof-item 4"),
    pytest.param("heartbeat_s", 1.0, "jax", id="heartbeat_s-1.0-item 4"),
    pytest.param("chunk_deadline_s", 5.0, "jax", id="chunk_deadline_s-5.0-item 4"),
])
def test_unported_config_raises(tmp_path, field, value, item):
    kw = {"exact_certify_masks": False, field: value}
    if item is None:
        outs = {v: _outcomes(tmp_path, str(v), **dict(kw, **{field: v})) for v in (value, 4)}
        assert outs[value] == outs[4] and len(outs[4][0]) == 40
        return
    path = field in ("trace_out", "profile_dir")
    got = _outcomes(tmp_path, "port",
                    **dict(kw, **({field: str(tmp_path / "port" / value)} if path else {})))
    want = _jax_outcomes(tmp_path,
                         **dict(kw, **({field: str(tmp_path / "jax" / value)} if path else {})))
    assert got == want and len(got[0]) == 40
    if path:
        assert os.path.exists(tmp_path / "port" / value)


@pytest.mark.parametrize("kw", [
    # With integrity off the JAX package runs no recheck: the port accepts it.
    dict(integrity=False, integrity_recheck=0.05),
    # Timing-only settings (the stress presets' values): the pipeline depth
    # and the retry budget change no outcome of a fault-free run.
    dict(pipeline_depth=4, max_launch_retries=3, launch_backoff_s=0.5),
], ids=["recheck-without-integrity", "pipeline-and-retries"])
def test_accepted_settings_run_unchanged(tmp_path, kw):
    want = _outcomes(tmp_path, "base", exact_certify_masks=False,
                     integrity=kw.get("integrity", True))
    assert _outcomes(tmp_path, "set", exact_certify_masks=False, **kw) == want


def test_ibp_engine_and_mesh_raise(tmp_path):
    # The IBP path is ported: the case now runs it and requires JAX's
    # outcomes.  The mesh is ported too: an object that is not the port's
    # Mesh raises TypeError, and a one-shard mesh runs with the unsharded
    # outcomes.
    from fairify_tpu.verify import engine as jengine
    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.parallel.mesh import submesh
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.config import EngineConfig

    got = _outcomes(tmp_path, "ibp", engine=EngineConfig(use_crown=False))
    want = _jax_outcomes(tmp_path, engine=jengine.EngineConfig(use_crown=False))
    assert got[0] == want[0] and len(got[0]) == 40
    # The IBP path is the chunk loop; JAX's bins the last chunk's 8 padding
    # rows too (ROADMAP queue 3), the port's real rows only.
    for row in ("margin", "gap"):
        extra = np.asarray(want[1][row]) - np.asarray(got[1][row])
        assert (extra >= 0).all() and extra.sum() == 8
    with pytest.raises(TypeError, match="Mesh"):
        sweep.verify_model(flagship_net(device="cpu"), _cfg(tmp_path, exact_certify_masks=False),
                           mesh=object(), device="cpu")
    # A one-shard mesh runs the mesh branch (stage 0's certificate alone,
    # then the attack forward) with the unsharded run's outcomes.
    rep = sweep.verify_model(flagship_net(device="cpu"),
                             _cfg(tmp_path / "mesh", exact_certify_masks=False, grid_chunk=16),
                             resume=False, device="cpu", partition_span=(0, 40),
                             mesh=submesh(["cpu"]))
    assert [(o.partition_id, o.verdict, o.pruned_acc, o.compressions)
            for o in rep.outcomes] == _outcomes(tmp_path, "nomesh", exact_certify_masks=False)[0]


def test_cuda_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from fairify_tpu_torch.models.mlp import flagship_net, from_numpy
    from fairify_tpu_torch.verify import sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy([np.ones((2, 1), np.float32)], [np.zeros(1, np.float32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.verify_model(flagship_net(device="cpu"),
                           _cfg(tmp_path, exact_certify_masks=False))


def test_pack_net_layout_and_key_bits():
    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.utils import cuda_build

    net = seeded_net((5, 4, 3, 1), seed=2, device="cpu")
    params, dims = cuda_build.pack_net(net)
    assert list(dims) == [5, 4, 3, 1]
    off = 0
    for w, b, m in zip(net.weights, net.biases, net.masks):
        for t in (w.reshape(-1), b, m):
            assert torch.equal(params[off:off + t.numel()], t)
            off += t.numel()
    assert off == params.numel()
    keys = torch.tensor([[0, 2**32 - 1], [2**31, 5]], dtype=torch.int64)
    k32 = cuda_build.u32_keys(keys)
    assert k32.dtype == torch.int32
    assert ((k32.to(torch.int64) & 0xFFFFFFFF) == keys).all()


# What the soundness rule keeps out of every CUDA source and header
# (fairify_tpu/analysis/passes_sound.py's rules): reduced-precision types,
# the fast-math intrinsics and approximate PTX, and tensor-core products.
_UNSOUND = ("__half", "half2", "__nv_bfloat16", "cuda_fp16.h", "cuda_bf16.h", "__fdividef",
            "__expf", "__exp10f", "__logf", "__log2f", "__log10f", "__powf", "__sinf",
            "__cosf", "__tanf", "__sincosf", ".approx", "wmma", "mma.sync", "wgmma",
            "use_fast_math", "-ftz=true")


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cu"))
                         + sorted((PKG / "csrc").glob("*.cuh")), ids=lambda p: p.name)
def test_kernel_source_keeps_the_soundness_rule(path):
    # the code only: a comment may name what the rule keeps out
    src = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
    found = [tok for tok in _UNSOUND if tok in src]
    assert not found, (path.name, found)


def test_kernel_sources_are_present_and_standalone():
    from fairify_tpu_torch.utils import cuda_build

    for name in cuda_build.SOURCES:
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        assert '#include "common.cuh"' in src and 'extern "C"' in src
        assert "use_fast_math" not in src
    assert "-use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
