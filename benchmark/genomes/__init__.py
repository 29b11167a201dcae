"""One genome generator a module, found by the name a configuration's
``genome.generator`` gives: ``make(config)`` returns the genome as uint8
codes 0..3 (4 for N), deterministic in the configuration's ``genome_seed``."""
