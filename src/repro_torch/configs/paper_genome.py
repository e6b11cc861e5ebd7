"""The paper's own job configuration: parallel genome pattern searching on
the Placentia cluster (paper §Genome searching).

Not an LM architecture — the knobs of the reduction job used to validate
the multi-agent approaches and decision rules. The sizes mirror the paper:
512 MB (2^19 KB) replicated input, 5000 patterns of 15-25 bases, 7
chromosomes, 3 search nodes + 1 combiner (Z = 4), 1 h execution windows.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GenomeJobConfig:
    name: str = "paper-genome-search"
    cluster: str = "placentia"
    input_bytes: int = (2 ** 19) * 1024  # 512 MB (paper: redundant copies)
    n_patterns: int = 5000
    pattern_len_min: int = 15
    pattern_len_max: int = 25
    chromosomes: int = 7  # chrI..chrV, chrX, chrM
    n_search_nodes: int = 3
    n_combine_nodes: int = 1
    z_dependencies: int = 4  # 3 search -> 1 combine (+1 output edge)
    window_hours: float = 1.0
    ckpt_period_hours: float = 1.0

    @property
    def n_nodes(self) -> int:
        return self.n_search_nodes + self.n_combine_nodes


CONFIG = GenomeJobConfig()


def scaled(mb: float = 0.25, patterns: int = 24) -> GenomeJobConfig:
    """CPU-container-sized variant used by examples/genome_search.py."""
    return GenomeJobConfig(
        input_bytes=int(mb * 1e6), n_patterns=patterns
    )
