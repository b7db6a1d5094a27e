"""Dataset length statistics (data-sanity tool; a copy of
mtl_tpu/train/analyzer.py for the PyTorch port, over the port's
``SpectrogramDataset.get_utterance``).

Parity: trainer/asr/analyzer.py:23-70 — iterate the datasets, collect
source-frame and target-length stats per manifest, dump CSV + summary.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

from ..data.dataset import SpectrogramDataset
from ..utils.logger import log_print


class Analyzer:
    def analyze(self, datasets: Sequence[SpectrogramDataset],
                out_dir: str = "analysis") -> dict:
        os.makedirs(out_dir, exist_ok=True)
        summary = {}
        for m, ds in enumerate(datasets):
            src_lens, trg_lens = [], []
            hop = ds.cfg.audio.hop_length
            for manifest_id in range(len(ds.ids_list)):
                for i in range(len(ds.ids_list[manifest_id])):
                    wave, transcript = ds.get_utterance(manifest_id, i)
                    src_lens.append(1 + len(wave) // hop)
                    trg_lens.append(len(transcript))
            src = np.asarray(src_lens)
            trg = np.asarray(trg_lens)
            stats = {
                "count": len(src),
                "src_mean": float(src.mean()), "src_std": float(src.std()),
                "src_min": int(src.min()), "src_max": int(src.max()),
                "src_p50": float(np.percentile(src, 50)),
                "src_p95": float(np.percentile(src, 95)),
                "trg_mean": float(trg.mean()), "trg_std": float(trg.std()),
                "trg_min": int(trg.min()), "trg_max": int(trg.max()),
            }
            summary[f"dataset_{m}"] = stats
            path = os.path.join(out_dir, f"lengths_{m}.csv")
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["src_frames", "trg_len"])
                w.writerows(zip(src_lens, trg_lens))
            log_print(f"dataset {m}: {stats}")
        return summary
