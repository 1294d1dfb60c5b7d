"""The Gram-engine options of the port: checkpoint and resume, profiler
traces with the program's ranges and counters, pf_scale side files, and the
memory probe.

A resumed Gram must equal an uninterrupted one bit for bit (the Gram does
not depend on the batch), a complete checkpoint must recompute nothing, and
a checkpoint of another corpus must be rejected, as ``tests/test_gram.py``
holds the JAX engine.  The port's CLI runs with ``--device cpu`` and is held
to the JAX CLI, run with ``--checkpoint`` on the same files, within the
1.4e-2 band of ``stem_kernel_lite``.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import stem_kernel_lite as j_cli
from stem_kernel_tpu.gram import checkpoint as j_ckpt
from stem_kernel_tpu.gram.engine import PairKernelEngine as JEngine
from stem_kernel_tpu.io.profile import Alignment as JAlignment
from stem_kernel_tpu.models import dag as j_dag
from stem_kernel_tpu.utils import tracing as j_tracing
from stem_kernel_torch.cli import stem_kernel_lite as t_cli
from stem_kernel_torch.fold.bpmatrix import fold_sequences
from stem_kernel_torch.gram import checkpoint as t_ckpt
from stem_kernel_torch.gram.bucketed import bucketed_gram
from stem_kernel_torch.gram.engine import PairKernelEngine
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.io.profile import Alignment
from stem_kernel_torch.models import dag as t_dag
from stem_kernel_torch.utils import tracing as t_tracing
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

CLI_BAND = 1.4e-2
CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt
AMINO = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    made these small CLI runs 50-100x slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _feats(n=8, d=5, seed=4):
    return {"v": np.random.default_rng(seed).random((n, d)).astype(np.float32)}


def _dot(x, y):
    return (x["v"] * y["v"]).sum(-1)


def _counting(calls):
    def fn(x, y):
        calls.append(len(x["v"]))
        return _dot(x, y)
    return fn


def _poisoned(x, y):
    raise AssertionError("recomputed a completed unit")


def test_engine_checkpoint_resume(tmp_path):
    feats = _feats()
    path = str(tmp_path / "ck")
    g0 = PairKernelEngine(_dot, feats, device="cpu", batch_size=8, slab_batches=1).gram()
    # slab_batches=1: a unit is one batch of 8 pairs, 36 pairs in 5 units
    g1 = PairKernelEngine(_dot, feats, device="cpu", batch_size=8,
                          slab_batches=1).gram(checkpoint_path=path)
    assert np.array_equal(g1, g0)
    ck = t_ckpt.TileCheckpoint(path, 8, 8)
    assert ck.n_batches == 5 and ck.n_completed == 5

    # complete: nothing recomputes
    g2 = PairKernelEngine(_poisoned, feats, device="cpu", batch_size=8,
                          slab_batches=1).gram(checkpoint_path=path)
    assert np.array_equal(g2, g0)

    # one flag cleared: only that unit recomputes
    ck.done[0] = False
    ck.done.flush()
    calls = []
    g3 = PairKernelEngine(_counting(calls), feats, device="cpu", batch_size=8,
                          slab_batches=1).gram(checkpoint_path=path)
    assert np.array_equal(g3, g0)
    assert calls == [8]


def test_engine_checkpoint_partial_final_unit(tmp_path):
    # 36 pairs, batches of 8, two batches a unit: 3 units, the last of 4 pairs
    feats = _feats()
    path = str(tmp_path / "ck")
    g0 = PairKernelEngine(_dot, feats, device="cpu", batch_size=8).gram()
    eng = PairKernelEngine(_dot, feats, device="cpu", batch_size=8, slab_batches=2)
    assert np.array_equal(eng.gram(checkpoint_path=path), g0)
    ck = t_ckpt.TileCheckpoint(path, 8, 16)
    assert ck.n_batches == 3 and ck.n_completed == 3
    g2 = PairKernelEngine(_poisoned, feats, device="cpu", batch_size=8,
                          slab_batches=2).gram(checkpoint_path=path)
    assert np.array_equal(g2, g0)
    for unit, want in ((2, [4]), (1, [8, 8])):
        ck.done[unit] = False
        ck.done.flush()
        calls = []
        g3 = PairKernelEngine(_counting(calls), feats, device="cpu", batch_size=8,
                              slab_batches=2).gram(checkpoint_path=path)
        assert np.array_equal(g3, g0)
        assert calls == want
    assert t_ckpt.TileCheckpoint(path, 8, 16).n_completed == 3
    # another unit size is an error, not a silent resume
    with pytest.raises(ValueError, match="checkpoint"):
        PairKernelEngine(_dot, feats, device="cpu", batch_size=8,
                         slab_batches=1).gram(checkpoint_path=path)


def test_checkpoint_rejects_different_corpus(tmp_path):
    feats = _feats()
    path = str(tmp_path / "ck")
    PairKernelEngine(_dot, feats, device="cpu", batch_size=8).gram(checkpoint_path=path)
    other = {"v": feats["v"][::-1].copy()}  # same shapes, other content
    with pytest.raises(ValueError, match="fingerprint|written for"):
        PairKernelEngine(_dot, other, device="cpu", batch_size=8).gram(checkpoint_path=path)


@pytest.mark.parametrize("slab_batches", [1, 2, 16, 64])
def test_unit_and_fingerprint_match_the_jax_engine(tmp_path, slab_batches):
    """The unit is the JAX engine's slab of batches, and the fingerprint of
    a tensor mapping equals JAX's of the same arrays."""
    feats = _feats(n=60)
    t_eng = PairKernelEngine(_dot, feats, device="cpu", batch_size=4,
                             slab_batches=slab_batches)
    j_eng = JEngine(lambda x, y: jnp.sum(x["v"] * y["v"], -1), feats, batch_size=4,
                    slab_batches=slab_batches)
    for n_batches in (1, 3, 17, 100, 458, 1000, 5001):
        assert t_eng._slab_size(n_batches) == j_eng._slab_size(n_batches)
    t_ck = t_eng.checkpoint_for(str(tmp_path / "t"))
    j_ck = j_eng.checkpoint_for(str(tmp_path / "j"))
    assert (t_ck.batch_size, t_ck.n_pairs, t_ck.n_batches) == (
        j_ck.batch_size, j_ck.n_pairs, j_ck.n_batches)
    extra = {"w": torch.arange(10_000, dtype=torch.float32).reshape(100, 100),
             "m": torch.ones(3, dtype=torch.bool)}
    assert t_ckpt.features_fingerprint(t_eng.features, extra) == j_ckpt.features_fingerprint(
        feats, {k: v.numpy() for k, v in extra.items()})


def _buckets(seed=11, n1=7, n2=5, d=3):
    r = np.random.default_rng(seed)
    return [(np.arange(n1), {"v": torch.tensor(r.normal(size=(n1, d)), dtype=torch.float32)}, 1),
            (np.arange(n1, n1 + n2),
             {"v": torch.tensor(r.normal(size=(n2, d)), dtype=torch.float32)}, 1)]


def test_bucketed_gram_checkpoint_resume(tmp_path):
    buckets = _buckets()
    g0 = bucketed_gram(buckets, lambda _aux: _dot, device="cpu", batch_size=4)
    ck = str(tmp_path / "ck")
    g1 = bucketed_gram(buckets, lambda _aux: _dot, device="cpu", batch_size=4,
                       checkpoint_path=ck)
    assert np.array_equal(g1, g0)
    assert sorted(os.listdir(ck)) == sorted(
        f"block_{b}.{f}" for b in ("0_0", "0_1", "1_1")
        for f in ("values.npy", "done.npy", "meta.json"))
    # every unit done: the values come from the checkpoint, not the kernel
    for vp in glob.glob(os.path.join(ck, "*.values.npy")):
        v = np.lib.format.open_memmap(vp, mode="r+")
        v[:] = 7.5
        del v
    g2 = bucketed_gram(buckets, lambda _aux: _poisoned, device="cpu", batch_size=4,
                       checkpoint_path=ck)
    assert np.all(g2 == 7.5)
    # a fresh directory reproduces the true values
    g3 = bucketed_gram(buckets, lambda _aux: _dot, device="cpu", batch_size=4,
                       checkpoint_path=str(tmp_path / "ck2"))
    assert np.array_equal(g3, g0)


def test_bucketed_checkpoint_fingerprints_the_y_side(tmp_path):
    """A corpus whose second bucket alone differs is rejected at the first
    cross block, whose x side is unchanged."""
    buckets = _buckets()
    ck = str(tmp_path / "ck")
    bucketed_gram(buckets, lambda _aux: _dot, device="cpu", batch_size=4, checkpoint_path=ck)
    idx, feats, aux = buckets[1]
    other = buckets[:1] + [(idx, {"v": feats["v"].flip(0)}, aux)]
    calls = []
    with pytest.raises(ValueError, match="block_0_1"):
        bucketed_gram(other, lambda _aux: _counting(calls), device="cpu", batch_size=4,
                      checkpoint_path=ck)
    assert calls == []  # block_0_0 came from its checkpoint


def _write_corpus(tmp_path, n=4, seed=9):
    rng = np.random.default_rng(seed)

    def mutate(s):
        s = "".join(rng.choice(list("acgu")) if rng.random() < 0.1 else c for c in s)
        cut = int(rng.integers(0, 12))
        return s[cut:] if rng.random() < 0.5 else s + "acgu"[: cut % 5] * 3

    pos = [mutate(CORE) for _ in range(n)]
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    paths = {}
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", pos[:2]), ("tneg", neg[:1]),
                       ("other", [dinucleotide_shuffle(s, rng) for s in pos])):
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


def _train(main, out, p, *flags, neg="neg"):
    assert main([*flags, "--precision", "highest", "-n", out,
                 "+1", p["pos"], "-1", p[neg]]) == 0
    with open(out) as f:
        return f.read()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    p = _write_corpus(tmp)
    return tmp, p, _train(t_cli.main, str(tmp / "plain.dat"), p, "--device", "cpu")


def _largest_block(ck):
    """The done flags of the checkpointed block with the most pairs."""
    metas = glob.glob(os.path.join(ck, "*.meta.json"))
    best = max(metas, key=lambda m: json.load(open(m))["n_pairs"])
    return np.lib.format.open_memmap(best.replace(".meta.json", ".done.npy"), mode="r+")


def test_cli_checkpoint_resume_is_bit_identical(tmp_path, corpus, monkeypatch):
    _, p, plain = corpus
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "k.dat")
    calls = []
    make = t_cli.make_stem_lite_kernel_fn

    def counting_make(config, iters, *, device):
        fn = make(config, iters, device=device)

        def counted(x, y):
            calls.append(1)
            return fn(x, y)
        return counted

    monkeypatch.setattr(t_cli, "make_stem_lite_kernel_fn", counting_make)
    assert _train(t_cli.main, out, p, "--device", "cpu", "--checkpoint", ck) == plain
    full = len(calls)
    assert full > 0 and len(glob.glob(os.path.join(ck, "*.meta.json"))) >= 2

    # a complete checkpoint: no batch recomputes
    calls.clear()
    assert _train(t_cli.main, out, p, "--device", "cpu", "--checkpoint", ck) == plain
    assert calls == []

    # the last half of the largest block's units cleared: only they recompute
    done = _largest_block(ck)
    done[len(done) // 2:] = False
    done.flush()
    del done
    assert _train(t_cli.main, out, p, "--device", "cpu", "--checkpoint", ck) == plain
    assert 0 < len(calls) < full


# every port CLI that runs through run_app, with the slab of its JAX counterpart
RUN_APP_CLIS = {
    "stem_kernel_lite": ("stem_kernel_lite", [], "rna", 16),
    "bpla_kernel": ("bpla_kernel", [], "rna", 64),
    "la_kernel": ("la_kernel", [], "protein", 64),
    "stem_kernel -b 6": ("stem_kernel", ["-b", "6"], "rna", 16),
    "la_kernel_lite": ("la_kernel_lite", [], "rna", 64),
    "string_kernel": ("string_kernel", [], "rna", 64),
    "simpal": ("simpal", [], "rna", 64),
}


@pytest.mark.parametrize("name", sorted(RUN_APP_CLIS))
def test_checkpoint_on_every_run_app_cli(name, tmp_path, corpus, monkeypatch):
    """--checkpoint gives the plain run's Gram bit for bit; a resume from the
    complete checkpoint calls no kernel; the units follow the CLI's slab."""
    import importlib

    from stem_kernel_torch.gram import engine

    module, flags, kind, slab = RUN_APP_CLIS[name]
    main = importlib.import_module(f"stem_kernel_torch.cli.{module}").main
    if kind == "rna":
        p = corpus[1]
    else:
        r = np.random.default_rng(3)
        core = "".join(r.choice(list(AMINO), size=30))
        seqs = ["".join(r.choice(list(AMINO)) if r.random() < 0.1 else c for c in core)
                for _ in range(3)]
        p = {}
        for tag, ss in (("pos", seqs), ("neg", ["".join(r.permutation(list(x))) for x in seqs])):
            (tmp_path / f"{tag}.fa").write_text(
                "".join(f">{tag}{i}\n{x}\n" for i, x in enumerate(ss)))
            p[tag] = str(tmp_path / f"{tag}.fa")
    slabs, calls = [], []
    init = engine.PairKernelEngine.__init__

    def counting_init(self, kernel_fn, *args, **kwargs):
        def counted(x, y):
            calls.append(1)
            return kernel_fn(x, y)
        init(self, counted, *args, **kwargs)
        slabs.append(self._slab_batches)

    monkeypatch.setattr(engine.PairKernelEngine, "__init__", counting_init)

    def run(out, *extra):
        assert main(["--device", "cpu", *flags, *extra, "-n", str(tmp_path / out),
                     "+1", p["pos"], "-1", p["neg"]]) == 0
        return (tmp_path / out).read_bytes()

    plain = run("plain.dat")
    assert set(slabs) == {16 if module == "stem_kernel_lite" else slab}
    ck = str(tmp_path / "ck")
    assert run("a.dat", "--checkpoint", ck) == plain
    assert calls and glob.glob(ck + "*.meta.json") + glob.glob(os.path.join(ck, "*.meta.json"))
    calls.clear()
    assert run("b.dat", "--checkpoint", ck) == plain
    assert calls == []


def test_cli_checkpoint_of_another_corpus_is_rejected(tmp_path, corpus):
    _, p, _ = corpus
    ck = str(tmp_path / "ck")
    _train(t_cli.main, str(tmp_path / "a.dat"), p, "--device", "cpu", "--checkpoint", ck)
    with pytest.raises(ValueError, match="checkpoint"):
        _train(t_cli.main, str(tmp_path / "b.dat"), p, "--device", "cpu", "--checkpoint", ck,
               neg="other")


def test_cli_checkpoint_matches_jax_cli_checkpoint(tmp_path, corpus):
    _, p, plain = corpus
    t_out, j_out = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    assert _train(t_cli.main, t_out, p, "--device", "cpu",
                  "--checkpoint", str(tmp_path / "tck")) == plain
    _train(j_cli.main, j_out, p, "--checkpoint", str(tmp_path / "jck"))
    (t_labels, t_g), (j_labels, j_g) = read_precomputed(t_out), read_precomputed(j_out)
    assert t_labels == j_labels and t_g.shape == j_g.shape == (8, 8)
    assert np.abs(t_g - j_g).max() <= CLI_BAND


def _pf_files(tmp_path, counts):
    paths = []
    for name, count in counts.items():
        f = tmp_path / f"{name}.pf"
        f.write_text("\n".join(["1.07"] * count) + "\n")
        paths.append(str(f))
    return paths


def test_use_pf_scale_file_equals_the_plain_run(tmp_path, corpus):
    _, p, plain = corpus
    pf_pos, pf_neg, pf_tpos, pf_tneg = _pf_files(
        tmp_path, {"pos": 4, "neg": 4, "tpos": 2, "tneg": 1})
    out = str(tmp_path / "k.dat")
    assert t_cli.main(["--device", "cpu", "--use-pf-scale-file", "--precision", "highest",
                       "-n", out, "+1", p["pos"], pf_pos, "-1", p["neg"], pf_neg]) == 0
    assert open(out).read() == plain
    rows = {}
    for tag, flag, tr, ts in (("plain", [], [p["pos"], "-1", p["neg"]],
                               ["+1", p["tpos"], "-1", p["tneg"]]),
                              ("pf", ["--use-pf-scale-file"],
                               [p["pos"], pf_pos, "-1", p["neg"], pf_neg],
                               ["+1", p["tpos"], pf_tpos, "-1", p["tneg"], pf_tneg])):
        rows[tag] = str(tmp_path / f"{tag}_rows.dat")
        assert t_cli.main(["--device", "cpu", *flag, "-n", rows[tag], "+1", *tr,
                           "--test", *ts]) == 0
    assert open(rows["pf"]).read() == open(rows["plain"]).read()


def test_short_pf_scale_file_raises(tmp_path, corpus):
    _, p, _ = corpus
    pf_pos, pf_neg = _pf_files(tmp_path, {"pos": 1, "neg": 4})
    with pytest.raises(ValueError, match="pf_scale"):
        t_cli.main(["--device", "cpu", "--use-pf-scale-file", str(tmp_path / "k.dat"),
                    "+1", p["pos"], pf_pos, "-1", p["neg"], pf_neg])


def test_trace_dir_writes_a_trace_of_the_run(tmp_path, corpus):
    _, p, plain = corpus
    trace_dir = tmp_path / "trace"
    assert _train(t_cli.main, str(tmp_path / "k.dat"), p, "--device", "cpu",
                  "--trace-dir", str(trace_dir)) == plain
    with open(trace_dir / t_tracing.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::index_select" in names  # the Gram engine's gathers
    assert any(n.startswith("aten::") for n in names) and len(events) > 100
    # the program's stages, as ranges among the host's ops
    stages = {"gram", "fold", "string", "write", "read", "featurize", "dag", "pack", "block",
              "gather", "kernel", "fetch", "normalize", "stem", "k1"}
    assert {t_tracing.PREFIX + s for s in stages} <= names
    # function-scope ranges: the profiler copies user annotations, not these,
    # onto the device's timeline
    assert {e.get("cat") for e in events
            if e.get("name", "").startswith(t_tracing.PREFIX)} == {"cpu_op"}
    with open(trace_dir / t_tracing.COUNTERS_FILE) as f:
        counts = json.load(f)
    n = sum(open(p[k]).read().count(">") for k in ("pos", "neg"))
    assert counts["gram.pairs"] == n * (n + 1) // 2 and counts["gram.batches"] >= 1


def test_dag_memory_probe_matches_jax():
    seqs = ["gggcuauuagcucaguggua", CORE, "acguacguacgu"]
    bpps = fold_sequences(seqs, device="cpu")
    alns = [Alignment(rows=[s]) for s in seqs]
    t_dags = [t_dag.build_dag(a, b, [b]) for a, b in zip(alns, bpps)]
    j_dags = [j_dag.build_dag(JAlignment(rows=[s]), b, [b]) for s, b in zip(seqs, bpps)]
    got = t_tracing.dag_memory_probe(t_dags)
    assert got == j_tracing.dag_memory_probe(j_dags)
    assert got["total_bytes"] > 0 and got["max_live_nodes"] >= 1
    assert t_tracing.dag_memory_probe([]) == j_tracing.dag_memory_probe([])
