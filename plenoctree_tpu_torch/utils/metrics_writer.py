"""Metrics sink: a machine-readable metrics.jsonl.

Port of plenoctree_tpu/utils/metrics_writer.py without its TensorBoard
events (tensorboardX is not on every machine the port runs on); the jsonl
lines are the JAX package's ({"tag", "value", "step", "ts"}).
"""

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag, value, step):
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()}) + "\n"
        )
        self._jsonl.flush()

    def close(self):
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
