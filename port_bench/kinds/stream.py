"""One live stream: ``serve.StreamingClassifier.feed`` over a recording,
fed in blocks back to back by one closed-loop client.

The traffic file gives the recording (seconds, the lengths of its
single-class segments), the block fed per call and the classifier's chunk
and hop. At the end of the recording the stream is reset and fed again.
Each feed is timed on the host clock from the call to its scores on the
host; the p95 is over every feed of the window. Set-up feeds the whole
recording once.

``correct`` compares the running scores that every feed of the window's
last whole pass returned with the reference's running mean of its chunks'
log-probabilities.
"""
import sys
import time

import numpy as np
import torch

from port_bench import program, signals, work
from port_bench.reference import logmel as ref_logmel


# the host work a traced stretch names (``program.host_spans``)
SPANS = ("lidbox_tpu_torch.serve:StreamingClassifier.feed",
         "lidbox_tpu_torch.serve:StreamingClassifier._score_chunk",
         "lidbox_tpu_torch.data.device_pipeline:"
         "DeviceFeatureExtractor.host_tensor")


class Cell:
    e2e = "stream_chunk_p95_ms"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.kernel_shapes = set()

    def setup(self):
        ctx, t, f = self.ctx, self.traffic, self.config["features"]
        rate = f["sample_rate"]
        total = int(t["recording_s"] * rate)
        rng = np.random.default_rng(signals.sub_seed(ctx.seed, signals.ORDER))
        parts = signals.segments(rng, total, int(t["segment_min_s"] * rate),
                                 int(t["segment_max_s"] * rate),
                                 self.config["num_outputs"])
        gen = signals.generator(ctx.seed, signals.INPUTS, ctx.device)
        longest = max(end - start for start, end, _ in parts)
        tones = signals.class_tones(gen, [lab for _, _, lab in parts],
                                    longest, rate, ctx.device)
        self.recording = torch.cat([
            tones[i, :end - start] for i, (start, end, _) in enumerate(parts)
        ]).cpu().numpy()
        block = int(t["block_s"] * rate)
        self.blocks = [self.recording[i:i + block]
                       for i in range(0, total, block)]
        # chunks due after each feed of a pass, and completed by it
        self.chunk = int(t["chunk_s"] * rate)
        self.hop = int(t["hop_s"] * rate)
        fed = np.cumsum([b.size for b in self.blocks])
        self.due = [0 if n < self.chunk else 1 + (n - self.chunk) // self.hop
                    for n in fed]
        self.new_chunks = np.diff([0] + self.due).tolist()
        self.weights = program.weights(self.config, ctx.seed, ctx.device)
        from lidbox_tpu_torch import serve
        self.stream = serve.StreamingClassifier(
            program.model(self.config, self.weights, ctx.device),
            program.labels(self.config),
            feature_config=program.feature_config(self.config),
            sample_rate=rate, chunk_seconds=t["chunk_s"],
            hop_seconds=t["hop_s"], device=ctx.device.type)
        with program.kernel_shapes(self.kernel_shapes):
            self._pass()

    def _pass(self):
        """Feeds the recording once from a reset stream."""
        self.stream.reset()
        for block in self.blocks:
            self.stream.feed(block)

    def window(self, seconds, trace=None):
        times = []
        start = time.perf_counter()
        deadline = start + seconds
        self.stream.reset()
        i, current, self.last_pass, self.chunks = 0, [], None, 0
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            scores = self.stream.feed(self.blocks[i])
            times.append(time.perf_counter() - t0)
            current.append(scores)
            self.chunks += self.new_chunks[i]
            i += 1
            if i == len(self.blocks):
                self.last_pass, current, i = current, [], 0
                self.stream.reset()
        elapsed = time.perf_counter() - start
        fifths = np.array_split(np.asarray(times), 5)
        print("note p95 by fifth of the window (ms): " + " ".join(
            f"{1e3 * np.percentile(t, 95):.4f}" for t in fifths if t.size),
            file=sys.stderr)
        out = {"start": start, "seconds": elapsed, "attempted": len(times),
               "failed": 0, "metrics": {"stream_chunk_p95_ms": 1e3 * float(
                   np.percentile(times, 95))}}
        if trace is not None:
            with program.host_spans(SPANS), trace:
                self._pass()
        return out

    def useful_flops(self):
        """Operations of the window's chunks: log-Mel and forward of each."""
        f = self.config["features"]
        fl = ref_logmel.ms_to_samples(f["sample_rate"], f["frame_length_ms"])
        fs = ref_logmel.ms_to_samples(f["sample_rate"], f["frame_step_ms"])
        m = ref_logmel.num_frames(self.chunk, fl, fs)
        return self.chunks * (work.forward_flops(self.config, m)
                              + work.logmel_flops(m, f))

    def release(self):
        del self.stream

    def check(self):
        """[(name, value)]: the widest gap between a returned running score
        and the reference's, over every feed of the window's last whole
        pass."""
        if self.last_pass is None:
            return [("passes_missing", 1.0)]
        f, chunk, hop = self.config["features"], self.chunk, self.hop
        device = self.ctx.device
        ref = program.reference_model(self.config)
        params = {k: v.to(torch.float64) for k, v in self.weights.items()}
        x = torch.as_tensor(self.recording, device=device).double()
        starts = list(range(0, x.shape[0] - chunk + 1, hop))
        chunk_scores = []
        with torch.no_grad():
            for i in range(0, len(starts), 64):
                sig = torch.stack([x[s:s + chunk] for s in starts[i:i + 64]])
                feats = ref_logmel.logmel(sig, **ref_logmel.feature_args(f))
                chunk_scores.append(ref.forward(params, feats, self.config))
        running = (torch.cumsum(torch.cat(chunk_scores), dim=0)
                   / torch.arange(1, len(starts) + 1, device=device)[:, None])
        running = running.cpu().numpy()
        gap, done = 0.0, 0
        for due, scores in zip(self.due, self.last_pass):
            if (scores is None) != (due == 0):
                return [("feeds_wrong", 1.0)]
            if scores is not None:
                gap = max(gap, float(np.abs(scores - running[due - 1]).max()))
                done = due
        if done != len(starts):
            return [("chunks_missing", float(len(starts) - done))]
        return [("running_score_gap", gap)]
