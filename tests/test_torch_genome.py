"""The genome-search job in the port against the JAX reference: the search's
hit lists record for record, the job's combined table, the fast search
against its plain version, and the job run under every FT strategy."""
import json
import random

import numpy as np
import pytest
import torch

import repro.core  # before anything that imports repro.telemetry (a circular import)
from repro.core.failure import FailureEvent as RFailureEvent
from repro.core.migration import DependencyGraph as RDependencyGraph
from repro.core.runtime import ClusterRuntime as RClusterRuntime
from repro.core.sim import measure_micro as r_measure_micro
from repro.data import genome as R
from repro.strategies import registry as r_strategies

from repro_torch.core.sim import MicroCosts
from repro_torch.data import genome as T
from repro_torch.launch import genome as launch

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

CPU = "cpu"


def _run_all(job, states=None):
    states = job.sub_job_states() if states is None else states
    for st in states:
        while job.run_sub_job_step(st):
            pass
    return states, job.combine(states)


def _plain(g, patterns, offset=0, chrom="chrI"):
    return T.search_chunk_plain(torch.from_numpy(np.ascontiguousarray(g)), patterns, offset, chrom)


@pytest.mark.parametrize("seed", [0, 2, 5, 9])
def test_make_genome_and_dictionary_equal_reference(seed):
    g, p, truth = T.make_genome(5000, n_patterns=7, seed=seed)
    rg, rp, rtruth = R.make_genome(5000, n_patterns=7, seed=seed)
    assert np.array_equal(g, rg) and truth == rtruth
    assert all(np.array_equal(a, b) for a, b in zip(p, rp)) and len(p) == len(rp)
    d, rd = T.make_pattern_dictionary(50, seed=seed), R.make_pattern_dictionary(50, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(d, rd))


def _edge_genome():
    """A genome with the reference's edge cases planted: codes 4 and 7 inside
    planted copies, a 32-base and a 1-base pattern, two pattern ids with one
    sequence, and a pattern that is its own reverse complement."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, size=3000, dtype=np.uint8)
    pats = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (15, 20, 25)]
    pats.append(g[700:732].copy())  # length 32, found where it was cut from
    pats.append(np.array([2], np.uint8))  # length 1: every G
    pats.append(pats[0].copy())  # a duplicate of pattern 0
    pal = np.array([0, 1, 2, 3], np.uint8)  # ACGT: its own reverse complement
    pats.append(pal)
    for pid, pos in ((0, 100), (0, 2985), (1, 500), (2, 1500), (6, 40)):
        g[pos: pos + len(pats[pid])] = pats[pid]
    g[1500 + 3] = 4  # breaks one copy of pattern 2
    g[2000] = 7
    g[2990] = 4  # inside the copy of pattern 0 at the end
    return g, pats


@pytest.mark.parametrize("case", ["edge", "minus_strand", "planted", "random"])
@pytest.mark.parametrize("offset,chrom", [(0, "chrI"), (12345, "chrX")])
def test_search_chunk_equals_reference(case, offset, chrom):
    if case == "edge":
        g, pats = _edge_genome()
    elif case == "minus_strand":
        g, pats, _ = R.make_genome(8000, n_patterns=3, seed=5)
    elif case == "planted":
        g, pats, _ = R.make_genome(20000, n_patterns=6, seed=2)
    else:
        rng = np.random.default_rng(3)
        g = rng.integers(0, 4, size=6000, dtype=np.uint8)
        pats = [rng.integers(0, 4, size=int(n), dtype=np.uint8) for n in rng.integers(1, 33, 40)]
    want = R.search_chunk(g, pats, offset, chrom)
    assert T.search_chunk(g, pats, offset, chrom, device=CPU) == want
    assert _plain(g, pats, offset, chrom) == want
    if case == "edge":
        assert any(h[3] == 3 for h in want) and any(h[3] == 6 and h[4] == "-" for h in want)


@pytest.mark.parametrize("n", [0, 1, 14, 15, 31])
def test_chunk_shorter_than_a_pattern(n):
    g, pats = _edge_genome()
    chunk = g[100: 100 + n]
    want = R.search_chunk(chunk, pats[:4])
    assert T.search_chunk(chunk, pats[:4], device=CPU) == _plain(chunk, pats[:4]) == want
    assert all(h[2] - h[1] + 1 <= n for h in want)


def test_patterns_outside_the_reference_domain_raise():
    g = np.zeros(100, np.uint8)
    for bad in (np.zeros(33, np.uint8), np.zeros(0, np.uint8), np.array([0, 4], np.uint8)):
        with pytest.raises(ValueError, match="pattern 0"):
            T.search_chunk(g, [bad], device=CPU)


# ---------------------------------------------------- the job (test_genome) ---
def test_boundary_straddling_hits_equal_reference():
    rng = np.random.default_rng(42)
    G = 4000
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    pat = rng.integers(0, 4, size=20, dtype=np.uint8)
    plants = [G // 4 - 10, 2 * (G // 4), 3 * (G // 4) - 5]
    for pos in plants:
        genome[pos: pos + len(pat)] = pat
    _, got = _run_all(T.GenomeSearchJob(genome, [pat], n_search=2, chunks_per_node=2, device=CPU))
    _, want = _run_all(R.GenomeSearchJob(genome, [pat], n_search=2, chunks_per_node=2))
    assert got == want
    starts = [h[1] for h in got]
    assert all(starts.count(pos) == 1 for pos in plants)
    _, whole = _run_all(T.GenomeSearchJob(genome, [pat], n_search=1, chunks_per_node=1, device=CPU))
    assert got == whole


@pytest.mark.parametrize("G,n_search,chunks", [(4000, 2, 2), (1000, 3, 4), (250000, 3, 4), (7, 3, 4)])
def test_chunk_bounds_equal_reference(G, n_search, chunks):
    t = T.GenomeSearchJob(np.zeros(G, np.uint8), [], n_search=n_search, chunks_per_node=chunks,
                          device=CPU)
    r = R.GenomeSearchJob(np.zeros(G, np.uint8), [], n_search=n_search, chunks_per_node=chunks)
    for node in range(n_search):
        for cursor in range(chunks + 1):
            assert t.chunk_bounds(node, cursor) == r.chunk_bounds(node, cursor)


def test_planted_truth_and_combiner_order_invariance():
    genome, patterns, truth = T.make_genome(20000, n_patterns=6, seed=2)
    job = T.GenomeSearchJob(genome, patterns, n_search=3, device=CPU)
    states, want = _run_all(job)
    assert not truth - {(h[1], h[3], h[4]) for h in want}
    shuffled = [dict(st, hits=list(st["hits"])) for st in states]
    random.Random(0).shuffle(shuffled)
    for st in shuffled:
        random.Random(st["node"]).shuffle(st["hits"])
    assert job.combine(shuffled) == want == sorted(want)
    rec = ("chrI", 5, 20, 0, "+")
    dup = [{"node": 0, "cursor": 1, "hits": [rec, rec]}, {"node": 1, "cursor": 1, "hits": [rec]}]
    assert job.combine(dup) == [rec]


@pytest.fixture(scope="module")
def example_job():
    """The example's defaults: 0.25 MB, 24 patterns, seed 7, 3 search nodes."""
    genome, patterns, truth = R.make_genome(int(0.25 * 1e6), n_patterns=24, seed=7)
    _, want = _run_all(R.GenomeSearchJob(genome, patterns, n_search=3))
    return genome, patterns, truth, want


def test_job_combined_table_equals_reference_at_example_scale(example_job):
    genome, patterns, truth, want = example_job
    _, got = _run_all(T.GenomeSearchJob(genome, patterns, n_search=3, device=CPU))
    assert got == want and len(got) > 0
    assert not truth - {(h[1], h[3], h[4]) for h in got}


@pytest.mark.parametrize("seed", [1, 4, 8])
def test_fast_search_equals_plain(seed, monkeypatch):
    monkeypatch.setattr(T, "_PLAIN_BATCH", 17)  # several batches, a short last one
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=20000, dtype=np.uint8)
    g[rng.integers(0, 20000, 20)] = 4  # scattered codes outside 0..3
    pats = T.make_pattern_dictionary(60, pat_len=(1, 32), seed=seed)
    pats += [g[p: p + len(q)].copy() for p, q in zip(rng.integers(0, 19000, 20), pats)]
    gt = torch.from_numpy(g)
    index = T.PatternIndex.build(pats, CPU)
    for lo, hi in ((0, 20000), (37, 5000), (19990, 20000)):
        fast = T.search_chunk(gt[lo:hi], pats, lo, index=index)
        assert fast == T.search_chunk_plain(gt[lo:hi], pats, lo) and len(fast) > 0


def test_genome_upload_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, pats = _edge_genome()
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.GenomeSearchJob(g, pats).upload()
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.search_chunk(g, pats)


# ------------------------------------------------------- FT runs (example) ---
def _reference_ft_run(genome, patterns, strategy, micro):
    """examples/genome_search.py's FT run, on the reference."""
    job = R.GenomeSearchJob(genome, patterns, n_search=3)
    rt = RClusterRuntime(n_hosts=4, n_spares=1, profile="placentia", graph=RDependencyGraph.star(3))
    states = job.sub_job_states()
    strat = r_strategies.get(strategy)
    strat.attach(rt, dict(enumerate(states)), micro=micro)
    job.run_sub_job_step(states[0])
    out = strat.on_prediction(RFailureEvent(t=900.0, node=0, predictable=True),
                              strat.pick_target(0, require_free=True))
    states[0] = rt.hosts[out.new_host].shard
    _, hits = _run_all(job, states)
    return out, hits


@pytest.mark.parametrize("strategy", r_strategies.names())
def test_ft_run_matches_reference(strategy, example_job):
    genome, patterns, _, want = example_job
    r_micro = r_measure_micro("placentia", n_nodes=4)
    out, ref_hits = _reference_ft_run(genome, patterns, strategy, r_micro)
    micro = MicroCosts(**{f: getattr(r_micro, f) for f in MicroCosts.__dataclass_fields__})
    got = launch.ft_run(T.GenomeSearchJob(genome, patterns, n_search=3, device=CPU), strategy, micro)
    assert got["hits"] == ref_hits == want
    assert (got["to"], got["outcome"], got["hash_ok"]) == \
        (out.new_host, out.outcome, out.report.get("hash_ok", True))
    assert got["mechanism"] == (out.mechanism or out.report.get("kind", "checkpoint"))
    if not out.migrated:
        assert got["reinstate_s"] == out.reinstate_s  # modelled: bitwise


def test_genome_launcher_all_strategies_on_cpu(capsys):
    assert launch.main(["--device", "cpu", "--genome-mb", "0.05", "--patterns", "8",
                        "--strategy", "all", "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] and res["missing"] == 0 and res["device"] == "cpu"
    assert [r["strategy"] for r in res["runs"]] == r_strategies.names()
    assert all(r["identical"] for r in res["runs"])
