"""``StreamingAligner(params).run(records)`` of the program, scores only or
with traces (the mix's ``alignments``), a closed loop: the generator never
runs dry and ``run()`` takes records as fast as it asks for them.  The
window counts the results ``run()`` yields."""

import time
from itertools import islice

from portbench import generator, reference
from portbench.harness import BATCH, Keep, sync


class Entry:

    def __init__(self, cell, seed, root, engine, device):
        from bialign_tpu_torch.parallel.driver import (PairRecord,
                                                       StreamingAligner)

        self._PairRecord = PairRecord
        mix = cell.mix
        self.alignments = bool(mix.get("alignments"))
        self.chunk = int(mix["chunk_pairs"])
        self.aligner = StreamingAligner(
            dict(cell.config["params"]), chunk_pairs=self.chunk,
            bucket_quantum=int(mix["bucket_quantum"]),
            alignments=self.alignments, engine=engine, device=device)
        self.device = device
        self.records = {}           # id -> record, every record fed
        self.fed = []               # ids in the order fed
        self.records_s = 0.0        # seconds spent making records
        self.keep = Keep(seed, every=64)
        self.answers = {}           # id -> (score, trace or None)
        self.order = []             # ids in the order answered
        self.longest = None         # (size, id) of the longest window
        self.seed, self.root, self.cell = seed, root, cell

    def _feed(self, recs, until=None, prefix=""):
        pos = 0
        while True:
            if until is not None and pos % self.chunk == 0 and until():
                return
            t = time.perf_counter()
            rec = next(recs, None)
            if rec is None:
                return
            self.records_s += time.perf_counter() - t
            rec = (prefix + rec[0],) + rec[1:]
            self.records[rec[0]] = rec
            self.fed.append(rec[0])
            pos += 1
            yield self._PairRecord(*rec)

    def warm(self):
        """Two chunks of the mix's records from a stream of their own (the
        window's records do not depend on it), then the window's own
        generator started and its first chunk taken."""
        warm = generator.records(self.cell.config, self.cell.mix,
                                 self.seed + 1, self.root)
        recs = (self._PairRecord(*r) for r in islice(warm, 2 * self.chunk))
        for _ in self.aligner.run(recs):
            pass
        self.stream = self.aligner.run(self._feed(generator.records(
            self.cell.config, self.cell.mix, self.seed, self.root)))
        self.primed = {out[0] for out in islice(self.stream, self.chunk)}

    def window(self, run, seconds):
        t0 = time.perf_counter()
        d0, r0 = self.aligner.dispatch_seconds, self.records_s
        n = 0
        end = t0 + seconds
        for out in self.stream:
            self._take(out)
            n += 1
            if n % 64 == 0 and time.perf_counter() >= end:
                break
        t1 = time.perf_counter()
        run.window_s = t1 - t0
        run.answered = n
        run.counters["dispatch_seconds"] = self.aligner.dispatch_seconds - d0
        run.counters["records_seconds"] = self.records_s - r0
        self.stream.close()
        self.window_ids = list(self.order)

    def _take(self, out):
        """Keep an answer: every score; the traces of the whole pairs, of a
        seeded share of the windows and of the longest window so far."""
        rid, score = out[0], out[1]
        trace = out[2] if self.alignments else None
        self.order.append(rid)
        if not rid.startswith("full-"):
            rec = self.records[rid]
            size = len(rec[1]) + len(rec[2])
            if self.longest is None or size > self.longest[0]:
                self.longest = (size, rid)
            elif trace is not None and not self.keep(len(self.order)):
                trace = None
        self.answers[rid] = (score, trace)

    def slice(self, run, seconds):
        """Whole chunks of the window's stream, until ``seconds`` passed,
        through a run of their own that ends drained."""
        sync(self.device)
        end = time.perf_counter() + seconds
        recs = self._feed(generator.records(self.cell.config, self.cell.mix,
                                            self.seed + 2, self.root),
                          until=lambda: time.perf_counter() >= end,
                          prefix="slice-")
        steps = 0
        pairs = []
        for out in self.aligner.run(recs):
            rec = self.records[out[0]]
            pairs.append((len(rec[1]), len(rec[2])))
            if self.alignments:
                steps += len(out[2])
        run.traced_pairs, run.traced_steps = pairs, steps

    def close(self):
        del self.aligner, self.stream

    def _answered(self):
        return [r for r in self.window_ids if r not in self.primed]

    def sample(self):
        """The windows compared, in batches for the reference: a seeded
        sample of those the window answered (with their traces kept) and
        the longest; then the first whole pair, if any, for all of them."""
        rng = generator.rng_of(self.seed, 3)
        answered = self._answered()
        windows = [r for r in answered if not r.startswith("full-")
                   and (not self.alignments
                        or self.answers[r][1] is not None)]
        want = int(self.cell.mix["check"]["sample"])
        picks = set(rng.choice(len(windows), size=min(want, len(windows)),
                               replace=False).tolist()) if windows else set()
        sample = [windows[p] for p in sorted(picks)]
        if self.longest and self.longest[1] not in sample \
                and self.longest[1] in answered:
            sample.append(self.longest[1])
        recs = sorted((self.records[r] for r in sample),
                      key=lambda r: len(r[1]) + len(r[2]))
        batches = [recs[lo:lo + BATCH] for lo in range(0, len(recs), BATCH)]
        fulls = [r for r in answered if r.startswith("full-")]
        if fulls:
            batches.append([self.records[fulls[0]]])
        return batches, fulls

    def _ids(self, rec, fulls):
        return [rec[0]] if not rec[0].startswith("full-") else fulls

    def answer_with(self, params, device, dtype):
        """The control: the reference computed in ``dtype`` put in the
        program's place on every answer the check compares."""
        batches, fulls = self.sample()
        for part in batches:
            got = reference.align([r[1:] for r in part], params,
                                  traces=self.alignments, device=device,
                                  dtype=dtype)
            for rec, ans in zip(part, got):
                for rid in self._ids(rec, fulls):
                    self.answers[rid] = (ans["score"], ans.get("trace"))

    def check(self, params, device):
        """Numbers compared: answers missing from the stream's order, and
        scores (and traces) that differ from the reference's on the sample,
        the longest window and every whole pair."""
        answered = self._answered()
        fed = [r for r in self.fed if r not in self.primed]
        missing = sum(1 for a, b in zip(answered, fed) if a != b)
        batches, fulls = self.sample()
        wrong_scores = wrong_traces = 0
        compared = 0
        for part in batches:
            ref = reference.align([r[1:] for r in part], params,
                                  traces=self.alignments, device=device)
            for rec, want in zip(part, ref):
                for rid in self._ids(rec, fulls):
                    score, trace = self.answers[rid]
                    compared += 1
                    wrong_scores += int(score != want["score"])
                    if self.alignments:
                        wrong_traces += int(
                            [tuple(c) for c in trace] != want["trace"])
        nums = {"missing_answers": missing, "wrong_scores": wrong_scores}
        if self.alignments:
            nums["wrong_traces"] = wrong_traces
        return nums, compared
