"""Metrics sink: TensorBoard events where tensorboardX is importable, and
a machine-readable metrics.jsonl beside them.

Port of plenoctree_tpu/utils/metrics_writer.py: the same scalars and
images go to a tensorboardX SummaryWriter in log_dir when there is one
(the GPU host has none, and then only the jsonl is written); the jsonl
lines are the JAX package's ({"tag", "value", "step", "ts"}).
"""

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def scalar(self, tag, value, step):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()}) + "\n"
        )
        self._jsonl.flush()

    def image(self, tag, img, step):
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(log_dir, tag):
    """[(step, value)] of one tag from log_dir/metrics.jsonl, in file order."""
    out = []
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append((rec["step"], rec["value"]))
    return out
