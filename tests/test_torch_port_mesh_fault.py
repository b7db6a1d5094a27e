"""The mesh epoch trainer's error path, on a 2-rank gloo group of its own.

On one process the epoch trainer skips a batch whose step raises, as the
JAX package's does (mtl_tpu/train/trainer.py:818-824). On a mesh the port
re-raises instead (mtl_tpu_torch/train/trainer.py, ``EpochTrainer``): the
other ranks are inside the step's collectives, so no rank can skip the
batch alone. Here rank 1's step raises at the first batch
(tests/torch_mesh_worker.py:epoch_train_failing_rank) and the run must end
with an error on rank 0 within its own time limit, not hang: rank 0's
collective fails once rank 1 is gone, and the launcher stops the ranks.

The run is a subprocess (its own process group, killed with its ranks at
the limit), apart from tests/test_torch_port_mesh.py's shared 4-rank group.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120

RUN = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from mtl_tpu_torch.cli import asr
from mtl_tpu_torch.config import build_parser
from tests.torch_mesh_worker import epoch_train_failing_rank
args = build_parser("epoch").parse_args({argv!r})
asr._train_on_mesh(args, "epoch", epoch_train_failing_rank, 1)
print("RUN ENDED WITHOUT AN ERROR")
"""


def test_mesh_epoch_trainer_reraises_a_rank_failure(tmp_path):
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=2, utts_per_task=8, max_sec=0.5,
        max_chars=6, seed=5)
    argv = ["--train-manifest-list", manifests[0],
            "--valid-manifest-list", manifests[1], "--labels-path", labels,
            "--src-buckets", "64", "--tgt-buckets", "16", "--batch-size",
            "4", "--epochs", "2", "--mesh-data", "2", "--device", "cpu",
            "--num-enc-layers", "1", "--num-dec-layers", "1", "--num-heads",
            "2", "--dim-model", "16", "--dim-key", "8", "--dim-value", "8",
            "--dim-inner", "16", "--dim-emb", "16", "--dropout", "0.0",
            "--r", "4", "--dtype", "float32", "--src-max-len", "64",
            "--tgt-max-len", "32", "--feat_extractor", "none", "--name",
            "fault", "--save-folder", str(tmp_path / "models")]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    start = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", RUN.format(repo=REPO, argv=argv)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the ranks too
        proc.communicate()
        pytest.fail(f"the mesh run did not end within {LIMIT_S} s (hang)")
    seconds = time.monotonic() - start
    print(f"the mesh run raised after {seconds:.1f} s: "
          f"{err.strip().splitlines()[-1][:300]}")
    assert proc.returncode != 0, out
    assert "RUN ENDED WITHOUT AN ERROR" not in out
    assert "planted step failure on rank 1" in err
    # rank 0 re-raised from its step's collective; it did not skip the batch
    assert "train/trainer.py" in err and "all_reduce" in err
    assert "skipping batch" not in out
    assert "TRAIN LOSS" not in out
