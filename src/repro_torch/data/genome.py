"""Genome pattern searching — the paper's validation job — on the card.

The paper searches 5000 nucleotide patterns (15-25 bases) against the
forward and reverse strands of 7 C. elegans chromosomes (ce2/ce6/ce10,
~512 MB replicated input), with N search nodes feeding one combiner node
(a parallel reduction). No network access here, so we *synthesise* a
genome of the same alphabet with planted pattern occurrences (ground
truth known exactly), sized to the experiment.

The port of ``repro.data.genome``. The reference dispatches one jit'd
AND-reduction of 32 shifted equalities per pattern per strand per chunk
(``_match_positions``, kept here as ``_match_positions_plain`` for the
tests and the card check). The search here is one pass per pattern
length instead:

* each genome window of 32 bases is packed 2 bits a base into an int64,
  first base lowest (``_windows``), and each position gets the length of
  the run of valid codes (0..3) starting there, cut at the chunk's end
  (``_valid_run``);
* the patterns of both strands are packed the same way, grouped by length
  L and sorted (``PatternIndex``); a key shared by several (pattern,
  strand) entries keeps a ``(start, end)`` range;
* for each length, the windows masked to L bases whose valid run is at
  least L are looked up among the sorted keys with ``torch.searchsorted``.

That is the reference's semantics: a hit needs ``i <= G - L``, a chunk
shorter than a pattern has no hit, and a genome code outside 0..3 matches
no pattern base. Records come out in the reference's order: pattern id,
then ``+`` before ``-``, then position. The genome is uploaded to the
device once per job, and the index is built once per job.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G
CHROMS = ["chrI", "chrII", "chrIII", "chrIV", "chrV", "chrX", "chrM"]
MAX_LEN = 32  # bases per packed window: 2 bits a base in an int64
_PLAIN_BATCH = 256  # (pattern, strand) rows per batch of the plain search
STRANDS = ("+", "-")


def make_genome(length: int, n_patterns: int = 50, pat_len=(15, 25), seed: int = 0):
    """Random genome (uint8 codes 0..3) + planted patterns + ground truth.

    Returns (genome, patterns(list of arrays), truth set of (start, pid, strand))."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=length, dtype=np.uint8)
    patterns = [
        rng.integers(0, 4, size=int(rng.integers(pat_len[0], pat_len[1] + 1)), dtype=np.uint8)
        for _ in range(n_patterns)
    ]
    truth = set()
    # plant each pattern a few times (forward and reverse strands)
    for pid, pat in enumerate(patterns):
        for _ in range(3):
            pos = int(rng.integers(0, length - len(pat)))
            genome[pos : pos + len(pat)] = pat
            truth.add((pos, pid, "+"))
        rc = COMPLEMENT[pat][::-1]
        pos = int(rng.integers(0, length - len(pat)))
        genome[pos : pos + len(pat)] = rc
        truth.add((pos, pid, "-"))
    # later plants may overwrite earlier ones: keep only entries whose bases
    # still match (ground truth must reflect the final genome)
    verified = set()
    for (pos, pid, strand) in truth:
        pat = patterns[pid] if strand == "+" else COMPLEMENT[patterns[pid]][::-1]
        if np.array_equal(genome[pos : pos + len(pat)], pat):
            verified.add((pos, pid, strand))
    return genome, patterns, verified


def make_pattern_dictionary(n: int = 5000, pat_len=(15, 25), seed: int = 1):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 4, size=int(rng.integers(pat_len[0], pat_len[1] + 1)), dtype=np.uint8)
        for _ in range(n)
    ]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return COMPLEMENT[seq][::-1]


def _strand_seqs(patterns: List[np.ndarray]):
    """(pid, strand index, sequence) for both strands of every pattern, in
    the reference's record order; lengths must be 1..32 and codes 0..3."""
    out = []
    for pid, pat in enumerate(patterns):
        pat = np.asarray(pat, np.uint8)
        if not 1 <= len(pat) <= MAX_LEN:
            raise ValueError(f"pattern {pid}: length {len(pat)} outside 1..{MAX_LEN}")
        if pat.max() > 3:
            raise ValueError(f"pattern {pid}: a code outside 0..3")
        out.append((pid, 0, pat))
        out.append((pid, 1, reverse_complement(pat)))
    return out


def _pack(seq: np.ndarray) -> int:
    """2 bits a base, first base lowest, as a signed int64 value."""
    v = sum(int(b) << (2 * j) for j, b in enumerate(seq))
    return v - (1 << 64) if v >= 1 << 63 else v


def _mask(L: int) -> int:
    return -1 if L == MAX_LEN else (1 << (2 * L)) - 1


@dataclass
class PatternIndex:
    """Both strands of every pattern, packed, grouped by length and sorted,
    on one device. ``groups[L] = (keys, starts, ends)``: the distinct keys
    of length L ascending and, for each, its range in ``entries`` (pattern
    id, strand index, length), which lists every (pattern, strand) of a
    key together."""

    groups: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    entries: torch.Tensor  # (E, 3) int64
    device: torch.device

    @staticmethod
    def build(patterns: List[np.ndarray], device) -> "PatternIndex":
        dev = torch.device(device)
        by_len: Dict[int, List[Tuple[int, int, int]]] = {}
        for pid, strand, seq in _strand_seqs(patterns):
            by_len.setdefault(len(seq), []).append((_pack(seq), pid, strand))
        groups, entries = {}, []
        for L in sorted(by_len):
            rows = sorted(by_len[L])
            keys = np.array([r[0] for r in rows], np.int64)
            uniq, first = np.unique(keys, return_index=True)
            base = len(entries)
            starts = base + first
            ends = np.append(starts[1:], base + len(rows))
            entries.extend((pid, strand, L) for _, pid, strand in rows)
            groups[L] = tuple(torch.from_numpy(a).to(dev) for a in (uniq, starts, ends))
        ent = torch.tensor(entries, dtype=torch.int64).reshape(-1, 3).to(dev)
        return PatternIndex(groups, ent, dev)


def _windows(g: torch.Tensor) -> torch.Tensor:
    """w[i] = sum_j (g[i + j] & 3) << 2j over j < 32, zero past the end, by
    doubling: five shifted ORs of the int64 windows."""
    G = g.shape[0]
    w = torch.zeros(G + MAX_LEN, dtype=torch.int64, device=g.device)
    w[:G] = g.to(torch.int64) & 3
    span = 1
    while span < MAX_LEN:
        w[: G + MAX_LEN - span] |= w[span:] << (2 * span)
        span *= 2
    return w[:G]


def _valid_run(g: torch.Tensor) -> torch.Tensor:
    """run[i] = the number of consecutive codes 0..3 from i on, up to the
    chunk's end: a window of L bases at i is searchable iff run[i] >= L."""
    G = g.shape[0]
    idx = torch.arange(G, dtype=torch.int64, device=g.device)
    # the stops (invalid codes, then the end) are few: find each position's
    # next one by a binary search among them, not by a scan over the chunk
    stops = torch.cat([torch.nonzero(g > 3).squeeze(1),
                       torch.full((1,), G, dtype=torch.int64, device=g.device)])
    return stops[torch.searchsorted(stops, idx)] - idx


def _match_hits(g: torch.Tensor, index: PatternIndex) -> torch.Tensor:
    """(n, 3) int64 rows (pid, strand index, position) of every hit, in the
    reference's order."""
    if g.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=g.device)
    w = _windows(g)
    run = _valid_run(g)
    parts = []
    for L, (keys, starts, ends) in index.groups.items():
        k = w & _mask(L)
        slot = torch.searchsorted(keys, k).clamp_(max=keys.numel() - 1)
        pos = torch.nonzero((keys[slot] == k) & (run >= L)).squeeze(1)
        slot = slot[pos]
        counts = ends[slot] - starts[slot]
        ent = torch.repeat_interleave(starts[slot], counts)
        ent += torch.arange(ent.numel(), device=g.device) - torch.repeat_interleave(
            torch.cumsum(counts, 0) - counts, counts)
        pos = torch.repeat_interleave(pos, counts)
        parts.append(torch.stack([index.entries[ent, 0], index.entries[ent, 1], pos], 1))
    if not parts:
        return torch.zeros((0, 3), dtype=torch.int64, device=g.device)
    hits = torch.cat(parts)
    # lexicographic (pid, strand, position): positions < 2^40, pid < 2^22
    order = torch.argsort((hits[:, 0] * 2 + hits[:, 1]) << 40 | hits[:, 2])
    return hits[order]


def _records(hits: np.ndarray, lengths: List[int], chunk_offset: int, chrom: str):
    return [
        (chrom, int(h) + chunk_offset, int(h) + chunk_offset + lengths[pid] - 1, int(pid),
         STRANDS[strand])
        for pid, strand, h in hits.tolist()
    ]


def _as_tensor(genome_chunk, device) -> torch.Tensor:
    if isinstance(genome_chunk, torch.Tensor):
        return genome_chunk
    return torch.from_numpy(np.ascontiguousarray(genome_chunk, np.uint8)).to(
        resolve_device(device))


def search_chunk(
    genome_chunk,
    patterns: List[np.ndarray],
    chunk_offset: int = 0,
    chrom: str = "chrI",
    *,
    device="cuda",
    index: Optional[PatternIndex] = None,
) -> List[Tuple[str, int, int, int, str]]:
    """Hits of every pattern (both strands) in one chunk.

    ``genome_chunk`` is a uint8 tensor (searched on its device) or a numpy
    array (uploaded to ``device``). ``index`` is the patterns' index on that
    device, built here when not given. Returns Fig-14-style records (chrom,
    start, end, pattern_id, strand), in the reference's order."""
    g = _as_tensor(genome_chunk, device)
    if index is None:
        index = PatternIndex.build(patterns, g.device)
    hits = _match_hits(g, index).cpu().numpy()
    return _records(hits, [len(p) for p in patterns], chunk_offset, chrom)


def _match_positions_plain(genome: torch.Tensor, pat_padded: torch.Tensor,
                           pat_len: torch.Tensor) -> torch.Tensor:
    """The reference's ``_match_positions`` in torch, for a batch of
    patterns: (P, 32) uint8 padded patterns and (P,) lengths -> (P, G) bool.
    An AND of 32 shifted equalities; positions past the valid window are
    False."""
    G = genome.shape[0]
    ok = torch.ones((pat_padded.shape[0], G), dtype=torch.bool, device=genome.device)
    for j in range(MAX_LEN):
        shifted = torch.roll(genome, -j)
        eq = shifted[None, :] == pat_padded[:, j, None]
        ok &= eq | (j >= pat_len)[:, None]
    idx = torch.arange(G, device=genome.device)
    return ok & (idx[None, :] <= G - pat_len[:, None])


def search_chunk_plain(genome_chunk: torch.Tensor, patterns: List[np.ndarray],
                       chunk_offset: int = 0, chrom: str = "chrI"
                       ) -> List[Tuple[str, int, int, int, str]]:
    """``search_chunk`` through ``_match_positions_plain``, ``_PLAIN_BATCH``
    (pattern, strand) rows at a time: the reference's loop, for checks."""
    seqs = _strand_seqs(patterns)
    dev = genome_chunk.device
    padded = np.zeros((len(seqs), MAX_LEN), np.uint8)
    for r, (_, _, seq) in enumerate(seqs):
        padded[r, : len(seq)] = seq
    pads = torch.from_numpy(padded).to(dev)
    lens = torch.tensor([len(s) for _, _, s in seqs], dtype=torch.int64, device=dev)
    rows = []
    for b in range(0, len(seqs), _PLAIN_BATCH):
        m = _match_positions_plain(genome_chunk, pads[b : b + _PLAIN_BATCH],
                                   lens[b : b + _PLAIN_BATCH])
        r, pos = torch.nonzero(m, as_tuple=True)  # row-major: (pid, strand) then position
        rows.append(torch.stack([r + b, pos], 1).cpu().numpy())
    rp = np.concatenate(rows) if rows else np.zeros((0, 2), np.int64)
    hits = np.stack([rp[:, 0] // 2, rp[:, 0] % 2, rp[:, 1]], 1)
    return _records(hits, [len(p) for p in patterns], chunk_offset, chrom)


@dataclass
class GenomeSearchJob:
    """The paper's job: N search sub-jobs over genome chunks -> 1 combiner.

    Each sub-job's STATE (its migratable payload) is {next chunk cursor,
    partial hit list}; the combiner's state is the merged table. Running
    the job under any FT policy must produce the identical sorted hit
    table (asserted in tests/examples). The genome and the pattern index
    are uploaded to ``device`` once, on the first step."""

    genome: np.ndarray
    patterns: List[np.ndarray]
    n_search: int = 3
    chrom: str = "chrI"
    chunks_per_node: int = 4
    device: str = "cuda"
    _on_device: Optional[Tuple[torch.Tensor, PatternIndex]] = field(
        default=None, init=False, repr=False, compare=False)

    def sub_job_states(self) -> List[Dict]:
        return [
            {"node": i, "cursor": 0, "hits": []} for i in range(self.n_search)
        ]

    def chunk_bounds(self, node: int, cursor: int) -> Optional[Tuple[int, int]]:
        G = len(self.genome)
        overlap = 31
        total_chunks = self.n_search * self.chunks_per_node
        cid = node * self.chunks_per_node + cursor
        if cursor >= self.chunks_per_node:
            return None
        size = G // total_chunks
        start = cid * size
        end = min(G, start + size + overlap)
        return start, end

    def upload(self) -> Tuple[torch.Tensor, PatternIndex]:
        """The genome and the pattern index on the job's device (once)."""
        if self._on_device is None:
            dev = resolve_device(self.device)
            g = torch.from_numpy(np.ascontiguousarray(self.genome, np.uint8)).to(dev)
            self._on_device = (g, PatternIndex.build(self.patterns, dev))
        return self._on_device

    def run_sub_job_step(self, state: Dict) -> bool:
        """Process one chunk; returns False when this sub-job is done.
        Interruptible at chunk granularity — exactly what migrates."""
        b = self.chunk_bounds(state["node"], state["cursor"])
        if b is None:
            return False
        start, end = b
        g, index = self.upload()
        hits = search_chunk(g[start:end], self.patterns, start, self.chrom, index=index)
        # drop duplicate overlap hits (same start found by the next chunk)
        nxt = self.chunk_bounds(state["node"], state["cursor"] + 1)
        if nxt is not None:
            hits = [h for h in hits if h[1] < nxt[0]]
        state["hits"].extend(hits)
        state["cursor"] += 1
        return state["cursor"] < self.chunks_per_node

    def combine(self, states: List[Dict]) -> List[Tuple]:
        allh = [h for st in states for h in st["hits"]]
        return sorted(set(allh))
