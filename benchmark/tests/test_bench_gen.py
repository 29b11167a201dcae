"""The benchmark's inputs. The frozen read simulator equals the program's
own at a small size, for one seed, so that a later change to the
program's cannot change what the benchmark feeds it unnoticed; the genome
generator plants what a configuration lists and no more; the wgsim
generator gives wgsim's rates and fragment lengths."""
import numpy as np
import pytest

from benchmark import gen, world
from benchmark.genomes import repeat_families
from benchmark.reads import wgsim
from tpubwa_torch.io import fastx
from tpubwa_torch.utils import dna

CFG = world.load_json(world.ROOT / "configs" / "human_chr20.json")


def _small(n=300_000, **genome):
    cfg = dict(CFG, genome_len=n, genome_seed=5)
    cfg["genome"] = dict(CFG["genome"], **genome)
    return cfg


@pytest.mark.parametrize("paired", [False, True])
def test_bench_reads_equal_program(paired):
    g = repeat_families.make(_small(60_000))
    kw = dict(read_len=150 if paired else 100, error_rate=0.01,
              indel_rate=0.001, seed=[2**31 + 9, 3], paired=paired,
              insert_mean=400, insert_std=50)
    want = fastx.simulate_reads(g, 300, **kw)
    got = gen.simulate_reads(g, 300, **kw)
    assert [r.name for r in want] == [n for n, _ in got]
    assert all(np.array_equal(dna.encode(r.seq), c)
               for r, (_, c) in zip(want, got))


def test_bench_genome_is_deterministic_at_its_gc():
    a = repeat_families.make(_small())
    assert np.array_equal(a, repeat_families.make(_small()))
    assert a.dtype == np.uint8 and a.max() <= 3
    gc = np.isin(a, (1, 2)).mean()
    assert abs(gc - CFG["genome"]["gc"]) < 0.03


def test_bench_genome_plants_its_copies():
    fam = {"name": "x", "consensus_len": 2000, "consensus_gc": 0.5,
           "copies": 5, "length_frac": [1.0, 1.0], "divergence": [0, 0, 1e-4],
           "source": "test"}
    g = repeat_families.make(_small(200_000, families=[fam]))
    bare = repeat_families.make(_small(200_000, families=[]))
    # five identical 2 kbp copies (either strand) over a random background
    k = 32
    words = {}
    for i in range(0, len(g) - k, 7):
        w = g[i:i + k].tobytes()
        words[w] = words.get(w, 0) + 1
    rc = {w: gen.revcomp(np.frombuffer(w, np.uint8)).tobytes()
          for w in words}
    counts = [words[w] + words.get(rc[w], 0) for w in words]
    assert max(counts) >= 2 and not np.array_equal(g, bare)


def test_bench_wgsim_rates_and_fragments():
    g = repeat_families.make(_small(400_000, families=[]))
    trf = world.load_json(world.ROOT / "traffic" / "pe150.json")
    trf = dict(trf, batch_records=2000)
    b = wgsim.make_batch(trf, g, 2**31 + 5, 0)
    assert b.n == 2000 and b.seqs.shape == (2000, 150)
    frag = np.array([int(n.split("_")[3]) for n in b.names[::2]])
    assert abs(frag.mean() - 500) < 10 and abs(frag.std() - 50) < 8
    # read 1 from the fragment's start: substitutions at -e + -r (1 - -R)
    pos = np.array([int(n.split("_")[2]) for n in b.names[::2]])
    r1 = b.seqs[::2]
    diff = np.mean([np.mean(r1[i] != g[p:p + 150]) for i, p in
                    enumerate(pos)])
    assert 0.015 < diff < 0.04
    assert np.array_equal(b.seqs, wgsim.make_batch(trf, g, 2**31 + 5, 0).seqs)
