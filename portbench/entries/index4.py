"""Entry `index4`: the index build of a read set over every local card,
both directions a unit, through `siga_tpu_torch.index.sa.bwt_perm_route`
(the choice `index -a sais2 --device cuda` makes for each direction: K6 on
the first card where it takes the text alone, else K8 over the cards).

The route is looked up before any input is made, so that a program without
it fails at once.  Set-up draws the reads as `generate.reads` does, from the
same streams, but gathers them on the device in chunks (a whole read set's
gather would take an int64 index a character), and makes their forward and
reversed rank texts, then warms up with one build.  The check compares the
BWT and `.sai` permutation of both directions of one build of the window,
drawn from the seed, with the blocked plain reference
(`reference/suffix_order_blocks.py`), its buckets split over the devices.
The counters are those of the distributed build (`dist_build.build_stats`)
over the window.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import generate
from ..reference import suffix_order_blocks
from ..roofline import bytes as roofline_bytes

CONTROL_CAP = 64  # the control sorts suffixes by their first 64 symbols: the seed alone
CHUNK_READS = 1 << 20  # reads gathered at once


def read_chunks(config: dict, seed: int, device, chunk: int = CHUNK_READS):
    """`generate.reads(config, seed)` in chunks of `chunk` reads (uint8
    tensors on `device`), from the same streams."""
    g = torch.from_numpy(generate.genome(config, seed)).to(device)
    n, length = generate.read_count(config), int(config["read_length"])
    r = generate.rng(seed, 1)
    starts = r.integers(0, g.numel() - length + 1, n)
    flip = np.zeros(n, dtype=bool)
    flip[r.permutation(n)[: n // 2]] = True
    span = torch.arange(length, device=device)
    for a in range(0, n, chunk):
        at = torch.from_numpy(starts[a : a + chunk]).to(device)
        rows = g[at[:, None] + span]
        f = torch.from_numpy(flip[a : a + chunk]).to(device)
        rows[f] = 5 - rows[f].flip(1)
        yield rows
        del at, rows, f


def texts(config: dict, seed: int, device) -> tuple:
    """(forward, reversed) rank texts of the configuration's reads
    (`generate.text` of `generate.reads`), made in chunks on `device`."""
    n, length = generate.read_count(config), int(config["read_length"])
    out = [np.zeros(n * (length + 1), dtype=np.uint8) for _ in range(2)]
    views = [torch.from_numpy(t).view(n, length + 1) for t in out]
    at = 0
    for rows in read_chunks(config, seed, device):
        m = rows.shape[0]
        views[0][at : at + m, :length] = rows.cpu()
        views[1][at : at + m, :length] = rows.flip(1).cpu()
        at += m
    return out[0], out[1]


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        from siga_tpu_torch.index import sa
        from siga_tpu_torch.parallel import dist_build

        self.build = sa.bwt_perm_route
        if traffic["text"] != "reads":
            raise ValueError("the index4 entry builds the configuration's reads")
        self.devices = sa.index_devices("cuda") if device.type == "cuda" else [device]
        self.stats = dist_build.build_stats
        self.texts = list(texts(config, seed, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.reads = generate.read_count(config)
        chars = int(self.texts[0].size)
        self.work = {"text_chars": 2 * chars}
        self.least_bytes = {"dist": 2 * roofline_bytes.index_build(chars, self.reads)}
        t0 = time.perf_counter()
        self.unit()
        warm_s = time.perf_counter() - t0
        # the build whose outputs are checked: one of those the window is
        # likely to hold, or the last where it holds fewer
        expected = max(1, int(seconds / warm_s))
        self.check_at = int(generate.rng(seed, 3).integers(0, expected))
        self.kept = self.last = None
        self.units = 0
        self.opened = dict(self.stats)

    def unit(self):
        return [self.build(t, self.devices) for t in self.texts]

    def keep(self, i: int, out) -> None:
        self.units = i + 1
        self.last = out
        if i == self.check_at:
            self.kept = out

    def counters(self) -> dict:
        """The distributed build's counts over the window: builds (a
        direction each), bytes moved between cards, host waits on a card."""
        return {k: v - self.opened[k] for k, v in self.stats.items()}

    def release(self) -> None:
        self.build = None
        if self.kept is None:  # the window ended before the drawn build
            self.kept, self.check_at = self.last, self.units - 1
        self.last = None

    def _judge(self, outputs) -> list:
        return judge(self.texts, outputs, self.devices)

    def check(self) -> tuple:
        compared = self._judge(self.kept)
        failed = int(any(v > limit for _n, v, limit in compared))
        print(f"[portbench] build {self.check_at} of the window's {self.units} (drawn from the "
              f"seed) checked against the blocked reference", file=sys.stderr, flush=True)
        return compared, failed

    def control(self, cap: int = CONTROL_CAP) -> list:
        """The check's numbers for the control: the reference's order cut to
        the first `cap` symbols, in the program's place."""
        outputs = []
        for codes in self.texts:
            blocks, _size = _buckets(codes, self.devices, cap,
                                     lambda b, p, at, pat: (at, b.cpu().numpy(), p.cpu().numpy()))
            blocks.sort(key=lambda x: x[0])
            outputs.append(tuple(np.concatenate(x) for x in list(zip(*blocks))[1:]))
            del blocks
        return self._judge(outputs)


def _buckets(codes: np.ndarray, devices, cap, fn) -> list:
    """The blocked reference's buckets of the rank text `codes` split over
    `devices`, one thread each (the text and its `plan` on every device,
    bucket i of the present ones on device i mod D): for each bucket,
    fn(bwt, perm, bucket's first row, its first read) in its thread.
    Returns (the results, device by device; (rows, reads) of the text)."""
    def work(k):
        c = torch.from_numpy(codes).to(devices[k])
        p = suffix_order_blocks.plan(c, cap)
        rows = np.cumsum([0] + p["counts"])
        reads = np.cumsum([0] + p["reads"])
        present = [v for v, m in enumerate(p["counts"]) if m]
        return [fn(*suffix_order_blocks.block(c, p, v), int(rows[v]), int(reads[v]))
                for v in present[k :: len(devices)]], (int(rows[-1]), int(reads[-1]))

    with ThreadPoolExecutor(len(devices)) as pool:
        parts = list(pool.map(work, range(len(devices))))
    return [r for part, _size in parts for r in part], parts[0][1]


def judge(texts, outputs, devices) -> list:
    """[(name, value, limit)]: the BWT symbols and permutation entries of the
    outputs ((bwt, perm) on the host, one a text) that differ from the
    blocked reference's, its buckets split over `devices`."""
    bwt_off = sai_off = 0
    for codes, (bwt, perm) in zip(texts, outputs):
        bwt, perm = np.asarray(bwt), np.asarray(perm)

        def differ(ref_bwt, ref_perm, at, pat):
            return (_differ(bwt[at : at + ref_bwt.numel()], ref_bwt),
                    _differ(perm[pat : pat + ref_perm.numel()], ref_perm))

        offs, (rows, reads) = _buckets(codes, devices, None, differ)
        bwt_off += sum(b for b, _p in offs) + max(bwt.size - rows, 0)
        sai_off += sum(p for _b, p in offs) + max(perm.size - reads, 0)
    return [("bwt_off", bwt_off, 0), ("sai_off", sai_off, 0)]


def _differ(got: np.ndarray, ref: torch.Tensor) -> int:
    """Entries of `ref` that `got` (a slice of the program's output at the
    same place) differs from, or lacks."""
    short = ref.numel() - got.size
    if got.size == 0:
        return short
    g = torch.from_numpy(np.ascontiguousarray(got)).to(ref.device, ref.dtype)
    return short + int((g != ref[: got.size]).sum())
