"""One read generator a module, found by the name a traffic file's
``generator`` gives: ``make_batch(traffic, genome, seed, index)`` returns
batch ``index`` of a run seeded ``seed`` (index -1: the warm-up) as a
``world.Batch``, the same for the same arguments."""
