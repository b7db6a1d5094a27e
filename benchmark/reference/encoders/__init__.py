"""The encoders of the benchmark's configurations, one file each, found by
a configuration's ``encoder_type``. ``encoders/<encoder_type>.py`` holds:

* ``param_shapes(c, out)``: adds the encoder's leaves to ``out``, in the
  checkpoint layout that ``reference/params.py`` documents (a LayerNorm's
  leaves have ``norm`` in their name, which is how ``weights.py`` fills
  them);
* ``forward(ref, W, x, lengths, gen)``: the plain f32 encoder on the VGG
  output x [B, T // 4, (F // 4) * 128] with the raw frame counts, built
  from ``Reference``'s own blocks (``lin``, ``dense``, ``ln``, ``drop``,
  ``attention``, ``mha``, ``ffn``, ``pad_masks``, ``sinusoid`` and
  ``ref.q``), so that the float8 control and the dropout masks pass
  through it;
* ``flops(c, b, t)``: its forward FLOPs on the VGG output of [B, T]
  features, counted as ``roofline.py`` counts them.

``params.param_shapes``, ``Reference.encode`` and ``roofline.encoder_flops``
call these through ``load``. So a configuration with a new encoder adds
its file here and edits nothing else. The operation and byte counts of
its own kernels may sit in that file or in a new module beside it; its
new metric readers import them from there, and ``roofline.py`` stays as
it is.
"""

from __future__ import annotations

import functools
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@functools.cache
def load(encoder_type: str):
    """The module of ``encoders/<encoder_type>.py``, loaded once."""
    path = os.path.join(HERE, encoder_type + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"encoder_type {encoder_type!r} has no file {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_encoder_" + encoder_type, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
