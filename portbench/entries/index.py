"""Entry `index`: the device index build of a read set, both directions a
unit, through `siga_tpu_torch.index.sa.bwt_perm_device` (what `index -a
sais2` runs for each direction after joining the reads).

Set-up draws the reads and makes their forward and reversed rank texts,
then warms up with one build.  The check compares the BWT and `.sai`
permutation of both directions of one build of the window, drawn from the
seed, with the plain reference (`reference/suffix_order.py`) on the card.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import generate
from ..reference import suffix_order
from ..roofline import bytes as roofline_bytes

CONTROL_CAP = 64  # the control sorts suffixes by their first 64 symbols: the seed alone


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        from siga_tpu_torch.index import sa

        if traffic["text"] != "reads":
            raise ValueError("the index entry builds the configuration's reads")
        self.build = sa.bwt_perm_device
        self.device = device
        rows = generate.reads(config, seed)
        self.texts = [generate.text(rows, reverse=r) for r in (False, True)]
        self.reads = rows.shape[0]
        del rows
        chars = int(self.texts[0].size)
        self.work = {"text_chars": 2 * chars}
        self.least_bytes = {"sa": 2 * roofline_bytes.index_build(chars, self.reads)}
        t0 = time.perf_counter()
        self.unit()
        warm_s = time.perf_counter() - t0
        # the build whose outputs are checked: one of those the window is
        # likely to hold, or the last where it holds fewer
        expected = max(1, int(seconds / warm_s))
        self.check_at = int(generate.rng(seed, 3).integers(0, expected))
        self.kept = self.last = None
        self.units = 0

    def unit(self):
        return [self.build(t, self.device) for t in self.texts]

    def keep(self, i: int, out) -> None:
        self.units = i + 1
        self.last = out
        if i == self.check_at:
            self.kept = out

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.build = None
        if self.kept is None:  # the window ended before the drawn build
            self.kept, self.check_at = self.last, self.units - 1
        self.last = None

    def _judge(self, outputs) -> list:
        """[(name, value, limit)]: the BWT symbols and permutation entries of
        both directions that differ from the reference's."""
        bwt_off = sai_off = 0
        for codes, (bwt, perm) in zip(self.texts, outputs):
            c = torch.from_numpy(codes).to(self.device)
            ref_bwt, ref_perm = suffix_order.index_arrays(c)
            del c
            bwt_off += _differ(torch.as_tensor(np.asarray(bwt)), ref_bwt)
            sai_off += _differ(torch.as_tensor(np.asarray(perm)), ref_perm)
            del ref_bwt, ref_perm
        return [("bwt_off", bwt_off, 0), ("sai_off", sai_off, 0)]

    def check(self) -> tuple:
        compared = self._judge(self.kept)
        failed = int(any(v > limit for _n, v, limit in compared))
        print(f"[portbench] build {self.check_at} of the window's {self.units} (drawn from the "
              f"seed) checked against the reference", file=sys.stderr, flush=True)
        return compared, failed

    def control(self, cap: int = CONTROL_CAP) -> list:
        """The check's numbers for the control: the reference's order cut to
        the first `cap` symbols, in the program's place."""
        outputs = []
        for codes in self.texts:
            c = torch.from_numpy(codes).to(self.device)
            bwt, perm = suffix_order.index_arrays(c, cap=cap)
            outputs.append((bwt.cpu().numpy(), perm.cpu().numpy()))
            del c, bwt, perm
        return self._judge(outputs)


def _differ(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Entries of `got` that differ from `ref`; every entry where the
    lengths differ."""
    if got.shape != ref.shape:
        return max(got.numel(), ref.numel())
    return int((got.to(ref.device, ref.dtype) != ref).sum())
