"""A codec lab's rate sweep: ``batch.run_sweep`` over one reference frame
and its degraded frames, one call a reference, the references in turn.

Each call is a fresh sweep (a new journal, ``resume=False``), as a lab
starts one per sequence frame: it loads and uploads the reference once,
prefetches the degraded files on side threads, and evaluates each pair
with the fold. The traffic file gives the pad policy (``pad``).
"""
from __future__ import annotations

import os
import time

from portbench.harness import Call, Pair


class Driver:
    def __init__(self, config, traffic, groups, device, work_dir):
        from open_pcc_metric_tpu_torch.batch import SweepItem

        self.opts, self.dtype = config["options"], config["dtype"]
        self.pad, self.device = traffic["pad"], device
        self.journal = os.path.join(work_dir, "journal.jsonl")
        self.items = [[SweepItem(g.reference.path, f.path, f.tag)
                       for f in g.degraded] for g in groups]
        self.sizes = {f.tag: (g.reference.points.shape[0], f.points.shape[0])
                      for g in groups for f in g.degraded}
        self.turn = 0

    def _call(self, gi: int) -> Call:
        from open_pcc_metric_tpu_torch.batch import run_sweep

        if os.path.exists(self.journal):
            os.remove(self.journal)
        t0 = time.perf_counter()
        records = run_sweep(
            self.items[gi], self.journal, color_scheme=self.opts["color"],
            point_to_plane=self.opts["point_to_plane"],
            d2_mode=self.opts["d2_mode"], dtype=self.dtype, resume=False,
            pad=self.pad, peak=self.opts["peak"], device=self.device)
        wall = time.perf_counter() - t0
        pairs = [Pair(r["tag"], *self.sizes[r["tag"]],
                      r.get("wall_s", wall), r.get("metrics"), r.get("error"),
                      j == 0)
                 for j, r in enumerate(records)]
        return Call(wall, pairs, records)

    def warm_up(self) -> None:
        for gi in range(len(self.items)):
            self._call(gi)

    def step(self) -> Call:
        gi = self.turn % len(self.items)
        self.turn += 1
        return self._call(gi)

    def install_spans(self, spans) -> None:
        pass

    def remove_spans(self) -> None:
        pass

    def close(self) -> None:
        self.items = []
