from repro_torch.data.genome import (
    GenomeSearchJob,
    make_genome,
    make_pattern_dictionary,
    search_chunk,
    reverse_complement,
)
