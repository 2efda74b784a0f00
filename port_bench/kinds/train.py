"""Training from waveform crops: ``ModelWrapper.fit_fused`` over a corpus
of host batches made from the seed.

The traffic file gives the corpus (batches, rows, seconds, optional silent
pauses, and its dtype: float32 waveforms or 16-bit PCM), the on-device
augmentation and the feed. One ``fit_fused`` call
runs epoch after epoch: its first epoch is set-up (the step's capture and
the first steps that ``correct`` reads), and the window is the whole
epochs after it, until the one in flight at the deadline ends; an epoch
ends on the loss being read back, a device synchronise. A traced run then
profiles one more epoch.

``correct`` follows the first three steps with the reference: the first
step's loss, the first gradient (Adam's first moment after step 1 over
1 - beta_1) and the parameters' change after step 3, leaf by leaf. The
losses of steps 2 and 3 are printed beside them but not compared: Adam's
first updates, about lr * g / (|g| + epsilon), turn the float32 rounding
of near-zero gradient elements into whole steps, so those losses part from
the float64 reference by up to 2e-3 on sound runs (PERF.md).
"""
import sys
import time

import numpy as np
import torch

from port_bench import program, signals, work
from port_bench.reference import logmel as ref_logmel
from port_bench.reference import train as ref_train
from port_bench.reference import vad as ref_vad
from port_bench.reference import wav as ref_wav

CHECK_STEPS = 3
# the host work a traced epoch names (``program.host_spans``)
SPANS = ("lidbox_tpu_torch.data.on_device:stage_signals",
         "lidbox_tpu_torch.data.on_device:pack_targets_int16",
         "lidbox_tpu_torch.data.on_device:to_device")


class _Epochs:
    """A ``fit_fused`` callback: marks the window's start at the end of
    epoch 1, its end at the first epoch end past the deadline, and, for a
    traced run, profiles one epoch more."""

    def __init__(self, seconds, trace):
        self.seconds, self.trace = seconds, trace
        self.start = self.end = None
        self.epochs = 0
        self.ends = []

    def on_train_begin(self, trainer):
        pass

    def on_epoch_begin(self, trainer, epoch):
        pass

    def on_train_end(self, trainer):
        pass

    def on_epoch_end(self, trainer, epoch, logs):
        now = time.perf_counter()
        if self.start is None:
            self.start = now
        elif self.end is None:
            self.epochs += 1
            self.ends.append(now)
            if now >= self.start + self.seconds:
                self.end = now
                if self.trace is None:
                    trainer.stop_training = True
                else:
                    self.spans = program.host_spans(SPANS)
                    self.spans.__enter__()
                    self.trace.__enter__()
        else:
            self.trace.__exit__(None, None, None)
            self.spans.__exit__(None, None, None)
            trainer.stop_training = True


class _FirstSteps:
    """Keeps what the first train steps leave: each step's loss, Adam's
    first moment after step 1 and the parameters after step
    ``CHECK_STEPS``; copies queued on the device after each step."""

    def __init__(self):
        from lidbox_tpu_torch.train import graphs
        self.program_class = graphs.StepProgram
        self.call = graphs.StepProgram.__call__
        self.losses, self.mu, self.params = [], None, None

    def __enter__(self):
        record = self

        def recording(program, trainer, state, inputs, generator=None):
            state, loss = record.call(program, trainer, state, inputs,
                                      generator)
            record.losses.append(loss.clone())
            if len(record.losses) == 1:
                record.mu = dict(zip(state.params, (
                    m.clone() for m in _moments(state.opt_state))))
            if len(record.losses) == CHECK_STEPS:
                record.params = {k: v.clone() for k, v in state.params.items()}
                record.program_class.__call__ = record.call
            return state, loss
        self.program_class.__call__ = recording
        return self

    def __exit__(self, *exc):
        self.program_class.__call__ = self.call
        return False


def _moments(opt_state):
    """Adam's first moments in an optimizer state (a tuple of the chained
    transforms' states)."""
    for s in opt_state:
        if isinstance(s, dict) and "mu" in s:
            return s["mu"]
    raise ValueError("no Adam state")


class Cell:
    e2e = "train_utt_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.kernel_shapes = set()

    def setup(self):
        ctx, t, f = self.ctx, self.traffic, self.config["features"]
        rate, rows = f["sample_rate"], t["batch_size"]
        n = t["batches"] * rows
        rng = np.random.default_rng(signals.sub_seed(ctx.seed, signals.ORDER))
        labels = rng.integers(self.config["num_outputs"], size=n)
        gen = signals.generator(ctx.seed, signals.INPUTS, ctx.device)
        x = signals.class_tones(gen, labels, int(t["seconds"] * rate), rate,
                                ctx.device)
        if t.get("pauses"):
            x = signals.with_pauses(gen, x, rate, t["pauses"]["min_s"],
                                    t["pauses"]["max_s"])
        if t["corpus_dtype"] == "int16":  # 16-bit PCM, as decoded audio
            x = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(
                torch.int16)
        x = x.cpu().numpy()
        self.batches = [(x[i:i + rows], labels[i:i + rows].astype(np.int64))
                        for i in range(0, n, rows)]
        self.weights = program.weights(self.config, ctx.seed, ctx.device)
        self.start_weights = {k: v.clone() for k, v in self.weights.items()}
        from lidbox_tpu_torch.models.model_utils import ModelWrapper
        self.wrapper = ModelWrapper.from_config(
            program.train_config(self.config, t, ctx.tmp),
            device=ctx.device.type)
        program.load_weights(self.wrapper.model.module, self.weights)

    def window(self, seconds, trace=None):
        epochs = _Epochs(seconds, trace)
        self.wrapper.trainer.callbacks.append(epochs)
        with _FirstSteps() as self.first, program.kernel_shapes(
                self.kernel_shapes):
            self.wrapper.fit_fused(self.batches, epochs=10 ** 9,
                                   verbose=False)
        self.steps = epochs.epochs * len(self.batches)
        self.epochs = epochs.epochs
        elapsed = epochs.end - epochs.start
        print("note window epochs (s): " + " ".join(
            f"{b - a:.4f}" for a, b in zip([epochs.start] + epochs.ends,
                                           epochs.ends)), file=sys.stderr)
        rows = self.steps * self.traffic["batch_size"]
        return {"start": epochs.start, "seconds": elapsed,
                "attempted": self.steps, "failed": 0,
                "metrics": {"train_utt_s": rows / elapsed}}

    def _vad_args(self):
        aug = self.traffic["on_device_augment"]
        if not aug.get("vad"):
            return None
        return {"frame_ms": aug.get("vad_frame_ms", 10),
                "min_non_speech_ms": aug.get("vad_min_non_speech_ms", 300),
                "strength": aug.get("vad_strength", 0.1)}

    def useful_flops(self):
        """Operations of the window's steps: each row's log-Mel and
        forward and backward over its valid frames (after the reference's
        VAD, where the traffic has one)."""
        f = self.config["features"]
        fl = ref_logmel.ms_to_samples(f["sample_rate"], f["frame_length_ms"])
        fs = ref_logmel.ms_to_samples(f["sample_rate"], f["frame_step_ms"])
        vad = self._vad_args()
        per_epoch = 0
        for signals_b, _ in self.batches:
            for row in signals_b:
                samples = row.size
                if vad is not None:
                    q = torch.as_tensor(ref_wav.pcm_values(row))
                    samples = ref_vad.remove_silence(
                        q, f["sample_rate"], **vad).shape[0]
                m = ref_logmel.num_frames(samples, fl, fs)
                per_epoch += (work.train_flops(self.config, m)
                              + work.logmel_flops(m, f))
        return per_epoch * self.epochs

    def release(self):
        del self.wrapper

    def _vad_note(self):
        """Rows of the checked batches whose kept length the package's VAD
        and the reference's disagree on."""
        vad = self._vad_args()
        if vad is None:
            return ""
        rate = self.config["features"]["sample_rate"]
        differ = 0
        for signals_b, _ in self.batches[:CHECK_STEPS]:
            q = torch.as_tensor(ref_wav.pcm_values(signals_b),
                                device=self.ctx.device)
            theirs = program.vad_lengths(q, rate, vad)
            differ += sum(ref_vad.remove_silence(row, rate, **vad).shape[0]
                          != n for row, n in zip(q, theirs))
        return f"; VAD lengths differ on {differ} rows"

    def check(self):
        """[(name, value)]: the first step's relative loss gap, and the
        worst leaf's gap between the program's and the reference's norms of
        the first gradient and of the change after ``CHECK_STEPS`` steps,
        each over the larger of that leaf's reference norm and the median
        leaf's. Leaves whose reference gradient is under a thousandth of
        the median leaf's, which only rounding moves under Adam, are left
        out of the change."""
        ref = program.reference_model(self.config)
        losses, grads, params = ref_train.train_steps(
            ref, self.start_weights, self.batches[:CHECK_STEPS], self.config,
            self._vad_args(), device=self.ctx.device)
        got_losses = [float(v) for v in self.first.losses[:CHECK_STEPS]]
        b1 = self.config["optimizer"]["beta_1"]
        names = list(grads)
        got_grads = {k: self.first.mu[k].double() / (1.0 - b1)
                     for k in names}
        start = {k: v.double() for k, v in self.start_weights.items()}

        def norms(tree):
            return {k: float(torch.linalg.vector_norm(tree[k]))
                    for k in names}
        g_ref, g_got = norms(grads), norms(got_grads)
        d_ref = norms({k: params[k] - start[k] for k in names})
        d_got = norms({k: self.first.params[k].double() - start[k]
                       for k in names})
        g_med, d_med = np.median(list(g_ref.values())), np.median(
            list(d_ref.values()))
        moved = [k for k in names if g_ref[k] >= 1e-3 * g_med]
        worst_g = max(names, key=lambda k: abs(g_got[k] - g_ref[k])
                      / max(g_ref[k], g_med))
        worst_d = max(moved, key=lambda k: abs(d_got[k] - d_ref[k])
                      / max(d_ref[k], d_med))
        print(f"note losses {got_losses} reference {losses}; worst first "
              f"gradient leaf {worst_g} ({g_got[worst_g]!r} against "
              f"{g_ref[worst_g]!r}, median leaf {g_med!r}); worst change "
              f"leaf {worst_d} ({d_got[worst_d]!r} against "
              f"{d_ref[worst_d]!r}, median leaf {d_med!r}); "
              f"{len(names) - len(moved)} leaves left out of the change"
              f"{self._vad_note()}", file=sys.stderr)
        return [
            ("first_loss_gap", abs(got_losses[0] - losses[0])
             / abs(losses[0])),
            ("grad_norm_gap", max(abs(g_got[k] - g_ref[k])
                                  / max(g_ref[k], g_med) for k in names)),
            ("update_norm_gap", float(max(abs(d_got[k] - d_ref[k])
                                          / max(d_ref[k], d_med)
                                          for k in moved)))]
