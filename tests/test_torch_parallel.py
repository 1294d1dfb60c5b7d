"""Multi-process Gram runs of the port: torch.distributed ranks on gloo.

The port's CLIs are the multi-process programs, as the JAX package's are
(tests/test_distributed.py).  Two ranks, each a process with ``--device
cpu`` and torchrun's variables set by hand, run ``stem_kernel_lite -n``
train and predict and ``bpla_kernel -n`` on a few sequences at a Gram batch
of 4 pairs, so that each rank runs several batches.  Their files must be
byte-equal to a one-rank run of the same jobs, within the CLI bands of the
JAX CLI run in this process with ``--devices 2`` (stem_kernel_lite 1.4e-2,
bpla_kernel 1.3e-3), and written by rank 0 alone.  All two-rank jobs run in
one spawn of two processes (tests/torch_rank_worker.py), one torch thread
each, so the file adds little load beside the other test workers; no test
asserts a timing ratio.
"""

import itertools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import bpla_kernel as j_bpla
from stem_kernel_tpu.cli import stem_kernel_lite as j_stem
from stem_kernel_torch.cli import app
from stem_kernel_torch.cli import bpla_kernel as t_bpla
from stem_kernel_torch.cli import stem_kernel_lite as t_stem
from stem_kernel_torch.cli import svm_tools
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.parallel import distributed as t_dist
from stem_kernel_torch.parallel.mesh import Mesh, process_zero, resolve_mesh, shard_pairs
from stem_kernel_torch.utils import tracing as t_tracing
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle
from torch_rank_worker import counting_run_app

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
STEM_BAND = 1.4e-2
BPLA_BAND = 1.3e-3
BATCH = 4  # Gram pairs a batch: 6 sequences make 6 batches of the train triangle
CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt
SPAWN_TIMEOUT = 240  # seconds, each rank of the one spawn
CPU = torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data(d):
    rng = np.random.default_rng(12)

    def mutate(s):
        s = "".join(rng.choice(list("acgu")) if rng.random() < 0.1 else c for c in s)
        cut = int(rng.integers(0, 12))
        return s[cut:] if rng.random() < 0.5 else s + "acgu"[: cut % 5] * 3

    pos = [mutate(CORE) for _ in range(3)]
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    paths = {}
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", pos[:2]), ("tneg", neg[:1])):
        f = d / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


def _jobs(p, model, o=""):
    """(cli, argv, expect_error) of each job; outputs under the prefix ``o``."""
    train = ["+1", p["pos"], "-1", p["neg"]]
    stem = ["--device", "cpu", "--precision", "highest", "-n"]
    return [
        ("stem_kernel_lite", [*stem, f"{o}km.dat", *train], False),
        ("stem_kernel_lite", [*stem, f"{o}rows.dat", "--model", model, "--predict", f"{o}pred",
                              "-x", f"{o}norm", "--stream-chunk", "2", *train,
                              "--test", "+1", p["tpos"], "-1", p["tneg"]], False),
        ("bpla_kernel", ["--device", "cpu", "-n", f"{o}bpla.dat", *train], False),
        ("stem_kernel_lite", [*stem, "--single-device", f"{o}single.dat", *train], False),
        ("stem_kernel_lite", [*stem, "--checkpoint", f"{o}ckpt", f"{o}ck.dat", *train], True),
        ("stem_kernel_lite", [*stem, "--devices", "3", f"{o}d3.dat", *train], True),
    ]


SHARDED = (0, 1, 2)  # jobs whose batches the two ranks split
OUTPUTS = {"km.dat", "rows.dat", "pred", "norm", "bpla.dat", "single.dat"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank run (this process) and the two-rank run of the jobs."""
    d = tmp_path_factory.mktemp("ranks")
    p = _data(d)
    one = d / "one"
    one.mkdir()
    model = str(one / "km.model")
    jobs = _jobs(p, model, o=f"{one}/")
    mods = {"stem_kernel_lite": t_stem, "bpla_kernel": t_bpla}
    one_pairs = []
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for i in SHARDED:
                cli, argv, _ = jobs[i]
                counter = [0]
                mp.setattr(mods[cli], "run_app", counting_run_app(BATCH, counter))
                assert mods[cli].main(argv) == 0
                one_pairs.append(counter[0])
                if i == 0:
                    assert svm_tools.train_main([str(one / "km.dat"), model]) == 0
    finally:
        torch.set_num_threads(saved)

    spec = d / "jobs.json"
    spec.write_text(json.dumps({"batch_size": BATCH, "jobs": _jobs(p, model), "scaling": True}))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               LOCAL_RANK="0")
    rank_dirs = [d / f"rank{r}" for r in range(2)]
    procs = []
    for r, cwd in enumerate(rank_dirs):
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_rank_worker.py"), str(spec)],
            cwd=cwd, env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"rank {r}: ok" in out, f"rank {r} failed:\n{out}"
    return {"files": p, "one": one, "ranks": rank_dirs, "outs": outs, "model": model,
            "one_pairs": one_pairs}


def _pairs(out: str, job: int) -> int:
    return int(out.split(f"job {job} pairs ")[1].split()[0])


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_stem_train_two_ranks_equal_one_rank(runs):
    rank0, one = runs["ranks"][0], runs["one"]
    assert _bytes(rank0 / "km.dat") == _bytes(one / "km.dat")
    p = runs["files"]
    j_out = str(one / "j_km.dat")
    assert j_stem.main(["--precision", "highest", "--devices", "2", "-n", j_out,
                        "+1", p["pos"], "-1", p["neg"]]) == 0
    (tl, tg), (jl, jg) = read_precomputed(str(rank0 / "km.dat")), read_precomputed(j_out)
    assert tl == jl == ["+1"] * 3 + ["-1"] * 3
    assert np.isfinite(tg).all() and np.abs(tg - jg).max() <= STEM_BAND


def test_stem_predict_two_ranks_equal_one_rank(runs):
    rank0, one, p = runs["ranks"][0], runs["one"], runs["files"]
    for f in ("rows.dat", "pred", "norm"):
        assert _bytes(rank0 / f) == _bytes(one / f), f
    j_rows = str(one / "j_rows.dat")
    assert j_stem.main(["--precision", "highest", "--devices", "2", "-n", j_rows,
                        "--model", runs["model"], "--stream-chunk", "2",
                        "+1", p["pos"], "-1", p["neg"],
                        "--test", "+1", p["tpos"], "-1", p["tneg"]]) == 0
    (tl, tr), (jl, jr) = read_precomputed(str(rank0 / "rows.dat")), read_precomputed(j_rows)
    assert tl == jl == ["+1", "+1", "-1"]
    assert tr.shape == jr.shape == (3, 6) and np.abs(tr - jr).max() <= STEM_BAND


def test_bpla_two_ranks_equal_one_rank(runs):
    rank0, one, p = runs["ranks"][0], runs["one"], runs["files"]
    assert _bytes(rank0 / "bpla.dat") == _bytes(one / "bpla.dat")
    j_out = str(one / "j_bpla.dat")
    assert j_bpla.main(["--devices", "2", "-n", j_out, "+1", p["pos"], "-1", p["neg"]]) == 0
    (tl, tg), (jl, jg) = read_precomputed(str(rank0 / "bpla.dat")), read_precomputed(j_out)
    assert tl == jl and np.abs(tg - jg).max() <= BPLA_BAND


def test_ranks_split_the_pairs(runs):
    """Each rank of a sharded job evaluates some pairs, and the two counts
    sum to the one-rank run's."""
    for k, job in enumerate(SHARDED):
        got = [_pairs(out, job) for out in runs["outs"]]
        assert min(got) > 0 and sum(got) == runs["one_pairs"][k], (job, got)


def test_rank_zero_alone_writes(runs):
    rank0, rank1 = runs["ranks"]
    assert sorted(os.listdir(rank1)) == []
    assert set(os.listdir(rank0)) == OUTPUTS


def test_single_device_runs_the_whole_gram_on_each_rank(runs):
    """--single-device under two ranks: plain dispatch on each rank (every
    rank evaluates every pair), rank 0 alone writes, the one-rank bytes."""
    assert _bytes(runs["ranks"][0] / "single.dat") == _bytes(runs["one"] / "km.dat")
    assert [_pairs(out, 3) for out in runs["outs"]] == [runs["one_pairs"][0]] * 2


def test_checkpoint_across_ranks_raises_on_both_ranks(runs):
    for out in runs["outs"]:
        assert "job 4 raised: Gram checkpointing is per-process" in out


def test_devices_past_the_ranks_raises(runs):
    for out in runs["outs"]:
        assert "job 5 raised: --devices 3 requested but only 2" in out


def test_scaling_efficiency_two_ranks(runs):
    effs = [json.loads(out.split("scaling ")[1].splitlines()[0]) for out in runs["outs"]]
    assert effs[0] == effs[1]
    assert set(effs[0]) == {"1", "2"}
    assert all(np.isfinite(v) and v > 0 for v in effs[0].values())


# ---- in one process, no spawn ----


def test_resolve_mesh_without_a_process_group():
    assert resolve_mesh(0) is None and resolve_mesh(1) is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m stem_kernel_torch"):
        resolve_mesh(2)
    assert process_zero()


def test_engine_on_the_global_mesh_of_one_process():
    """Without a group the global mesh is this process alone; an engine on
    it gives the plain engine's values bit for bit."""
    from stem_kernel_torch.gram.engine import PairKernelEngine

    mesh = t_dist.global_mesh()
    assert (mesh.ranks, mesh.rank, mesh.group) == ((0,), 0, None)
    v = torch.as_tensor(np.random.default_rng(3).random((7, 5), dtype=np.float32))
    grams = [PairKernelEngine(lambda x, y: (x["v"] * y["v"]).sum(-1), {"v": v}, device=CPU,
                              batch_size=3, mesh=m).gram(normalize=True) for m in (None, mesh)]
    assert np.array_equal(grams[0], grams[1])
    assert mesh.dealt == 10  # 28 pairs of the triangle in batches of 3


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_shard_pairs_covers_every_batch_once(size):
    """Every batch on exactly one rank, whichever rank takes batch 0; a
    mesh deals each job on from where the last one ended."""
    for n_batches in range(10):
        for first in range(size):
            got = sorted(b for r in range(size) for b in
                         shard_pairs(Mesh(tuple(range(size)), r), n_batches, first))
            assert got == list(range(n_batches))
    assert list(shard_pairs(None, 3)) == [0, 1, 2]
    mesh = Mesh(tuple(range(size)), 0)
    assert [mesh.deal(n) for n in (3, 1, 5, 2)] == [0, 3 % size, 4 % size, 9 % size]


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_gather_pair_values_is_bit_exact(size, monkeypatch):
    """Each fake rank's batches, merged back by gather_pair_values (the
    all-gather faked in process), give the pair values bit for bit: -0.0,
    NaN and inf included, a short last batch too."""
    bs = 3
    rng = np.random.default_rng(size)
    for n_pairs, first in itertools.product((0, 1, 3, 7, 19, 27), range(size)):
        vals = rng.normal(size=n_pairs).astype(np.float32)
        vals[::5] = -0.0
        vals[1::7] = np.nan
        vals[2::11] = -np.inf
        n_batches = -(-n_pairs // bs)
        meshes = [Mesh(tuple(range(size)), r) for r in range(size)]
        locals_ = []
        for m in meshes:
            mine = shard_pairs(m, n_batches, first)
            local = np.zeros(len(mine) * bs, np.float32)
            for k, b in enumerate(mine):
                chunk = vals[b * bs: (b + 1) * bs]
                local[k * bs: k * bs + len(chunk)] = chunk
            locals_.append(local)

        def fake_all_gather(parts, buf, group=None):
            for part, local in zip(parts, locals_):
                part.zero_()
                part[: len(local)] = torch.from_numpy(local)

        monkeypatch.setattr(t_dist.dist, "all_gather", fake_all_gather)
        for m, local in zip(meshes, locals_):
            got = t_dist.gather_pair_values(local, n_pairs, bs, m, first)
            assert got.dtype == np.float32
            assert np.array_equal(got.view(np.uint32), vals.view(np.uint32))


def test_rank_outside_the_mesh_does_nothing(tmp_path):
    def fail(*_):
        raise AssertionError("a rank outside the mesh featurized")

    opts = app.AppOptions(output=str(tmp_path / "k.dat"), labels=["+1"], files=["none.fa"])
    app.run_app(opts, fail, fail, device=CPU, mesh=Mesh((0, 1), 2))
    assert os.listdir(tmp_path) == []


def test_rank_device_and_trace_file_under_a_group(monkeypatch):
    """Under a process group, 'cuda' is the GPU of LOCAL_RANK, and a
    LOCAL_RANK past the host's GPUs raises naming both numbers; rank r > 0
    traces into trace_rank{r}.json."""
    assert t_dist.rank_device("cpu") == CPU
    assert t_tracing.trace_file() == "trace.json"
    monkeypatch.setattr(t_dist.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no GPU: this host shows 1 CUDA"):
        t_dist.rank_device("cuda")
    assert t_dist.rank_device("cpu") == CPU
    monkeypatch.setattr(t_tracing, "world", lambda: (1, 2))
    assert t_tracing.trace_file() == "trace_rank1.json"
