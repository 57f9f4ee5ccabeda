"""One pair at a time through the single-pair API, as the command line
runs it: ``BiAligner(...)``, ``optimize()``, ``traceback()`` and
``decode_trace()``, each call in a host span; the window is the pairs
started before its end, run to their end.  Each pair's record is made
before its timer starts (the span ``records``)."""

import time

import numpy as np

from portbench import generator, reference
from portbench.harness import BATCH, Keep, span, sync
from portbench.reference import decode as ref_decode


class Entry:

    def __init__(self, cell, seed, root, engine, device):
        from bialign_tpu_torch import BiAligner

        self.BiAligner = BiAligner
        self.params = dict(cell.config["params"])
        self.engine, self.device = engine, device
        self.cell, self.seed, self.root = cell, seed, root
        self.keep = Keep(seed, every=8)
        self.kept = {}          # request -> (record, tables, score, trace,
        self.longest = None     # lines); (size, request) of the longest

    def _ba(self, rec):
        return self.BiAligner(rec[1], rec[2], rec[3], rec[4],
                              engine=self.engine, device=self.device,
                              **self.params)

    def warm(self):
        """One pair of the mix through the device stages (the decode is host
        code with nothing to build)."""
        warm = generator.records(self.cell.config, self.cell.mix,
                                 self.seed + 1, self.root)
        ba = self._ba(next(warm))
        ba.optimize()
        ba.traceback()
        del ba
        self.records = generator.records(self.cell.config, self.cell.mix,
                                         self.seed, self.root)

    def _one(self, run):
        with span(run, "records"):
            rec = next(self.records)
        t = time.perf_counter()
        with span(run, "tables"):
            ba = self._ba(rec)
        with span(run, "fill"):
            score = ba.optimize()
        with span(run, "walk"):
            trace = ba.traceback()
        with span(run, "decode"):
            lines = ba.decode_trace(trace)
        run.request_s.append(time.perf_counter() - t)
        return rec, ba, score, trace, lines

    def window(self, run, seconds):
        t0 = time.perf_counter()
        end = t0 + seconds
        n = 0
        while True:
            rec, ba, score, trace, lines = self._one(run)
            n += 1
            size = len(rec[1]) + len(rec[2])
            keep = self.keep(n)
            if self.longest is None or size > self.longest[0]:
                if self.longest is not None and not self.keep(self.longest[1]):
                    del self.kept[self.longest[1]]
                self.longest = (size, n)
                keep = True
            if keep:
                self.kept[n] = (rec, (ba.mu1, ba.mu2), score, trace, lines)
            del ba
            if time.perf_counter() >= end:
                break
        run.window_s = time.perf_counter() - t0
        run.answered = n

    def slice(self, run, seconds):
        """Whole pairs until ``seconds`` passed, at least one."""
        sync(self.device)
        spans_before = {k: len(v) for k, v in run.spans.items()}
        times_before = len(run.request_s)
        end = time.perf_counter() + seconds
        pairs = []
        while True:
            rec = self._one(run)[0]
            pairs.append((len(rec[1]), len(rec[2])))
            if time.perf_counter() >= end:
                break
        # the slice's spans do not count in the window's
        for k, v in run.spans.items():
            del v[spans_before.get(k, 0):]
        del run.request_s[times_before:]
        run.traced_pairs = pairs

    def close(self):
        pass

    def sample(self):
        """The requests compared: a seeded sample of those kept, and the
        longest."""
        rng = generator.rng_of(self.seed, 3)
        ids = sorted(k for k in self.kept if k != self.longest[1])
        want = int(self.cell.mix["check"]["sample"])
        picks = rng.choice(len(ids), size=min(want, len(ids)),
                           replace=False).tolist() if ids else []
        return [ids[p] for p in sorted(picks)] + [self.longest[1]]

    def answer_with(self, params, device, dtype):
        """The control: the reference computed in ``dtype``, and the lines
        decoded from its trace, put in the program's place on every request
        the check compares."""
        sample = self.sample()
        rna = params["type"] == "RNA"
        for lo in range(0, len(sample), BATCH):
            ids = sample[lo:lo + BATCH]
            got = reference.align([self.kept[k][0][1:] for k in ids], params,
                                  traces=True, device=device, dtype=dtype)
            for k, ans in zip(ids, got):
                rec = self.kept[k][0]
                self.kept[k] = (rec, ans["tables"], ans["score"],
                                ans["trace"],
                                ref_decode.lines(ans["trace"], rec[1:],
                                                 rna=rna))

    def check(self, params, device):
        """Numbers compared on the sample and the longest pair: tables,
        scores, traces and decoded lines that differ from the reference's."""
        sample = self.sample()
        rna = params["type"] == "RNA"
        nums = dict(wrong_tables=0, wrong_scores=0, wrong_traces=0,
                    wrong_lines=0)
        self.decode_s = 0.0
        for lo in range(0, len(sample), BATCH):
            part = [self.kept[k] for k in sample[lo:lo + BATCH]]
            ref = reference.align([p[0][1:] for p in part], params,
                                  traces=True, device=device)
            for (rec, tabs, score, trace, lines), want in zip(part, ref):
                same_tables = all(
                    np.array_equal(np.asarray(a, np.int64), b)
                    for a, b in zip(tabs, want["tables"]))
                nums["wrong_tables"] += int(not same_tables)
                nums["wrong_scores"] += int(score != want["score"])
                nums["wrong_traces"] += int(
                    [tuple(c) for c in trace] != want["trace"])
                t = time.perf_counter()
                ref_lines = ref_decode.lines(want["trace"], rec[1:], rna=rna)
                self.decode_s += time.perf_counter() - t
                nums["wrong_lines"] += int(list(lines) != ref_lines)
        return nums, len(sample)
