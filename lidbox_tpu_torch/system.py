"""
System/IO utilities: subprocess helpers, checksums, duration queries, log
readers (counterpart of ``lidbox_tpu.system``; reference: lidbox/system.py).
"""
import hashlib
import json
import shlex
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

MAX_BATCH_SIZE = 5000


def run_command(cmd, timeout=None):
    """Run a shell command, returning (returncode, stdout, stderr)."""
    proc = subprocess.run(cmd, shell=isinstance(cmd, str), capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def run_for_files(cmd, filepaths, batch_size=MAX_BATCH_SIZE):
    """Run ``cmd`` with file paths appended, batched to stay under argv
    limits; yields stdout per batch (reference: lidbox/system.py:8-22)."""
    filepaths = list(filepaths)
    for begin in range(0, len(filepaths), batch_size):
        batch = filepaths[begin:begin + batch_size]
        # quote every path: spaces/metacharacters in filenames must not
        # split arguments or reach the shell as syntax
        _, out, _ = run_command(
            f"{cmd} {' '.join(shlex.quote(str(p)) for p in batch)}")
        yield out


def md5sum(path):
    """Streaming MD5 of a file (reference: lidbox/system.py:46-48)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def all_md5sums(paths, num_workers=32):
    """MD5 of many files in parallel (reference: lidbox/system.py:50-53 used
    a 32-process pool; a thread pool suffices since hashing releases the
    GIL during IO)."""
    paths = list(paths)  # before sizing the pool: len() must not consume
    # a generator argument (it previously did, returning [])
    with ThreadPoolExecutor(
            max_workers=min(num_workers, max(1, len(paths)))) as pool:
        return list(pool.map(md5sum, paths))


def get_total_duration_sec(paths):
    """Total audio duration via soxi when available, else wav headers
    (reference: lidbox/system.py:65-75; fixes the reference's missing sox
    import noted in SURVEY.md §7)."""
    paths = list(paths)
    if shutil.which("soxi"):
        total = 0.0
        for out in run_for_files("soxi -D", paths):
            total += sum(float(line) for line in out.splitlines() if line.strip())
        return total
    import wave
    total = 0.0
    for p in paths:
        with wave.open(str(p), "rb") as f:
            total += f.getnframes() / f.getframerate()
    return total


def get_total_duration(paths):
    """Total duration as (hours, mins, secs)
    (reference: lidbox/system.py:71-75)."""
    secs = round(get_total_duration_sec(paths))
    mins, secs = secs // 60, secs % 60
    hours, mins = mins // 60, mins % 60
    return hours, mins, secs


def format_duration(duration):
    """(hours, mins, secs) -> '01h 02min 03sec'
    (reference: lidbox/system.py:77-78)."""
    return "{:02d}h {:02d}min {:02d}sec".format(*duration)


def get_audio_type(path):
    """Audio container type from the file header."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    return "unknown"


def read_arff_features(path, include_keys=None, exclude_keys=("frameTime",),
                       types=("numeric",)):
    """Numeric feature matrix from an openSMILE ARFF file via scipy
    (reference: lidbox/system.py:24-38). Returns (data [T, F], keys)."""
    import numpy as np
    from scipy.io import arff
    data, meta_info = arff.loadarff(path)
    keys = [k for k in meta_info.names()
            if (include_keys is None or k in include_keys)
            and k not in (exclude_keys or ())
            and meta_info[k][0] in types]
    mat = np.stack([np.asarray(data[k], np.float32) for k in keys], axis=-1)
    return mat, keys


def iter_log_events(path):
    """Iterate (wall_time, step, tag, value) records from a metrics log.

    Reads this package's JSONL event logs (written by
    lidbox_tpu_torch.train.observability.MetricsLogger); a TensorBoard
    event file (``tfevents`` in the name, as the logger's
    ``torch.utils.tensorboard`` mirror writes) is read through the
    ``tensorboard`` package when it imports (reference:
    lidbox/system.py:55-63 read TF event files only)."""
    path = str(path)
    if "tfevents" in path:
        from tensorboard.backend.event_processing.event_file_loader import \
            EventFileLoader
        from tensorboard.util import tensor_util
        for event in EventFileLoader(path).Load():
            for value in event.summary.value:
                if value.HasField("tensor"):
                    scalar = float(tensor_util.make_ndarray(value.tensor))
                else:
                    scalar = value.simple_value
                yield event.wall_time, event.step, value.tag, scalar
        return
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            for tag, value in rec.get("metrics", {}).items():
                yield rec.get("wall_time"), rec.get("step"), tag, value
