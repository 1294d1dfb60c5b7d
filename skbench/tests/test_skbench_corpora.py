"""The seeded corpora repeat exactly, and every seed runs the same sizes."""

import collections
from pathlib import Path

import numpy as np
import pytest

from skbench import flows
from skbench.corpora import family, mixed
from skbench.corpora.dishuffle import dinucleotide_shuffle
from skbench.harness import cell_of

BIG_SEED = 2**31 + 977  # seeds reach past 32 signed bits


def _dinucleotides(s):
    return collections.Counter(s[i:i + 2] for i in range(len(s) - 1))


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_dishuffle_keeps_counts_and_repeats(seed):
    s = "".join(np.random.default_rng(1).choice(list("acgu"), 120))
    a = dinucleotide_shuffle(s, np.random.default_rng(seed))
    b = dinucleotide_shuffle(s, np.random.default_rng(seed))
    assert a == b
    assert collections.Counter(a) == collections.Counter(s)
    assert _dinucleotides(a) == _dinucleotides(s)
    assert a[0] == s[0] and a[-1] == s[-1]


@pytest.mark.parametrize("cell", ["stem_lite.train", "full_stem.train", "stem_lite.predict"])
def test_job_corpora_repeat_and_differ(cell, tmp_path):
    c = cell_of(cell)
    gen = {"family": family, "mixed": mixed}[c.config["corpus"]["generator"]]

    def corpus(seed, index, sub):
        d = tmp_path / sub
        d.mkdir()
        flow = flows.FLOWS[c.traffic["flow"]](c.config, c.traffic, gen, seed, "cpu", d)
        flow.setup()
        job = flow.make_job(index)
        return job.test if job.test is not None else job.corpus, job

    a, ja = corpus(BIG_SEED, 3, "a")
    b, jb = corpus(BIG_SEED, 3, "b")
    other, _ = corpus(BIG_SEED, 4, "c")
    assert a == b
    assert Path(ja.argv[-1]).read_text() == Path(jb.argv[-1]).read_text()
    assert a["pos"] != other["pos"]


@pytest.mark.parametrize("cell", ["stem_lite.train", "full_stem.train"])
def test_train_work_is_the_same_for_every_seed(cell, tmp_path):
    """The train mix's work_seed fixes each job's sequences; the run's seed
    orders them."""
    c = cell_of(cell)
    gen = {"family": family, "mixed": mixed}[c.config["corpus"]["generator"]]
    corpora = []
    for seed in (5, BIG_SEED):
        d = tmp_path / str(seed)
        d.mkdir()
        corpora.append(flows.TrainFlow(c.config, c.traffic, gen, seed, "cpu", d).make_job(2).corpus)
    a, b = corpora
    for k in ("pos", "neg"):
        assert sorted(a[k]) == sorted(b[k]) and a[k] != b[k]


def test_family_runs_the_same_families_in_order():
    spec = cell_of("stem_lite.train").config["corpus"]
    cores = {}
    for seed in (1, 2, BIG_SEED):
        for job in range(8):
            c = family.make(spec, np.random.default_rng([seed, job]), job)
            want = spec["core_lengths"][job % len(spec["core_lengths"])]
            assert {len(s) for s in c["pos"] + c["neg"]} == {want}
            assert len(c["pos"]) == len(c["neg"]) == spec["per_class"]
            assert cores.setdefault(job, c["core"]) == c["core"]  # the seed draws no core
    model = family.make(spec, np.random.default_rng(1), None)
    assert len(model["core"]) == spec["model_core_length"]


def test_mixed_runs_the_same_lengths():
    spec = cell_of("full_stem.train").config["corpus"]
    seen = set()
    for seed in (1, 2, BIG_SEED):
        c = mixed.make(spec, np.random.default_rng(seed), 0)
        lens = tuple(sorted(len(s) for s in c["pos"] + c["neg"]))
        seen.add(lens)
        assert lens[0] == spec["length_range"][0] and lens[-1] == spec["length_range"][1]
    assert len(seen) == 1


def test_predict_model_file(tmp_path):
    c = cell_of("stem_lite.predict")
    flow = flows.PredictFlow(c.config, c.traffic, family, BIG_SEED, "cpu", tmp_path)
    flow.setup()
    lines = flow.model_path.read_text().splitlines()
    sv = lines[lines.index("SV") + 1:]
    k = c.traffic["support_vectors_per_class"]
    assert len(sv) == 2 * k
    coef = np.array([float(line.split()[0]) for line in sv])
    lo, hi = c.traffic["coefficient_range"]
    assert (coef[:k] >= lo).all() and (coef[:k] <= hi).all()
    assert (-coef[k:] >= lo).all() and (-coef[k:] <= hi).all()
    idx = [int(line.split()[1].split(":")[1]) - 1 for line in sv]
    n_pos = len(flow.model_corpus["pos"])
    assert all(i < n_pos for i in idx[:k]) and all(i >= n_pos for i in idx[k:])
