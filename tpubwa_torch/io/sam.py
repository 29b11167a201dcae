"""SAM output utilities: coordinate sort, shard merge, resume manifest.

Replacements for the reference's post-processing Spark jobs and
batch-folder bookkeeping (SURVEY.md §2.1 merge/sort utilities, §5.3/§5.4
manifest-based restart): per-host SAM shards are merged deterministically by
read order, coordinate sorting is a host-side stable sort, and an output
manifest records completed batches so a crashed run resumes where it left
off (the analog of re-pointing the reference at remaining batch folders).
"""
from __future__ import annotations

import json
import os
from pathlib import Path


def split_header(sam_text: str) -> tuple[list[str], list[str]]:
    header, body = [], []
    for line in sam_text.split("\n"):
        if not line:
            continue
        (header if line.startswith("@") else body).append(line)
    return header, body


def _sq_order(header: list[str]) -> dict[str, int]:
    order = {}
    for line in header:
        if line.startswith("@SQ"):
            for f in line.split("\t"):
                if f.startswith("SN:"):
                    order[f[3:]] = len(order)
    return order


def coordinate_sort(sam_text: str) -> str:
    """Stable coordinate sort (rid, pos), unmapped last — `samtools sort`
    order for records; header passes through with @HD SO:coordinate."""
    header, body = split_header(sam_text)
    order = _sq_order(header)

    def key(line: str):
        f = line.split("\t", 4)
        rname, pos = f[2], int(f[3])
        if rname == "*":
            return (1, 0, 0)
        return (0, order.get(rname, len(order)), pos)

    body.sort(key=key)
    out_header = [h for h in header if not h.startswith("@HD")]
    out_header.insert(0, "@HD\tVN:1.6\tSO:coordinate")
    return "\n".join(out_header + body) + "\n"


def merge_shards(paths: list[str | Path], output: str | Path,
                 sort: bool = False) -> int:
    """Concatenate SAM shards (header from the first), optionally sorting.

    Shards are merged in the given order, which the aligner writes as
    ascending read-id ranges — so an unsorted merge reproduces the exact
    single-process output.
    """
    texts = [Path(p).read_text() for p in paths]
    header, body = split_header(texts[0])
    for t in texts[1:]:
        _, b = split_header(t)
        body.extend(b)
    out = "\n".join(header + body) + "\n"
    if sort:
        out = coordinate_sort(out)
    Path(output).write_text(out)
    return len(body)


class Manifest:
    """Append-only record of completed batches for crash-resume.

    Each line: {"batch": i, "n_reads": n, "path": shard}, synced to disk
    before ``mark`` returns. On restart the aligner skips batches already
    present (same effect as Spark's per-partition retry, without a
    cluster).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.done: dict[int, dict] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                if line.strip():
                    rec = json.loads(line)
                    self.done[rec["batch"]] = rec

    def is_done(self, batch: int) -> bool:
        return batch in self.done

    def mark(self, batch: int, n_reads: int, path: str = "") -> None:
        rec = {"batch": batch, "n_reads": n_reads, "path": path}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.done[batch] = rec
