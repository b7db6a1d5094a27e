"""Each configuration's encoder is found by its ``encoder_type`` in
``reference/encoders/``: the parameter shapes and the FLOP counts of the
cells read the same as when both encoders were written into
``params.py`` and ``roofline.py``, and an encoder file added alone is
taken up by the shapes, the reference and the FLOP count."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH

VOCAB = 4 + 3761  # PAD, SOS, EOS and OOV, then the configurations' labels
B, T, K = 8, 800, 3  # the meta cells' batches of 8 x 800 frames, K tasks

# read before the encoders moved into files of their own: the leaf count
# and the sha256 of the sorted (name, shape) pairs; the FLOPs of the
# encoder on [8, 800], of a meta step at label buckets 64 and 128 (+ 1
# teacher-forced position) and of a served batch decoding 33 and 88 steps
SHAPES = {
    "flagship": (190, "0dbc8e2d5c1f2c5729c72c97b8f1c3f9"
                      "b839868f89d980071d4616c52d621064"),
    "conformer17": (694, "9a33085b7d71446a021bff061575e837"
                         "aab0a6bcf5e17eaedf058c9e96938b55"),
}
FLOPS = {
    "flagship": {"encoder": 15676211200.0,
                 "meta": {65: 3891152240640.0, 129: 4040382431232.0},
                 "decode": {33: 212592238592.0, 88: 219237548032.0}},
    "conformer17": {"encoder": 1352764620800.0,
                    "meta": {65: 28383152209920.0, 129: 28913540825088.0},
                    "decode": {33: 1562837893120.0, 88: 1587201474560.0}},
}


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_param_shapes_unchanged(name):
    from reference.params import param_shapes

    shapes = param_shapes(_config(name), VOCAB)
    digest = hashlib.sha256(repr(sorted(shapes.items())).encode()).hexdigest()
    assert (len(shapes), digest) == SHAPES[name]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_unchanged(name):
    import roofline

    c, want = _config(name), FLOPS[name]
    assert roofline.encoder_flops(c, B, T) == want["encoder"]
    for l, fl in want["meta"].items():
        assert roofline.meta_step_flops(c, VOCAB, K, B, B, T, l) == fl
    for steps, fl in want["decode"].items():
        assert roofline.decode_flops(c, VOCAB, B, T, steps) == fl


def _param_shapes(c):
    from reference.params import param_shapes

    return param_shapes(c, VOCAB)


def _encoder_flops(c):
    import roofline

    return roofline.encoder_flops(c, B, T)


def _reference(c):
    from reference.model import Reference

    return Reference(c, "cpu")


@pytest.mark.parametrize("entry", [_param_shapes, _encoder_flops, _reference],
                         ids=["param_shapes", "encoder_flops", "Reference"])
def test_unknown_encoder_names_its_file(entry):
    c = dict(_config("flagship"), encoder_type="no_such_encoder")
    with pytest.raises(FileNotFoundError,
                       match="encoders/no_such_encoder.py"):
        entry(c)


# -- an encoder added as one new file ------------------------------------

TOY = '''"""One linear and one LayerNorm."""

import roofline
from reference import params


def param_shapes(c, out):
    params.linear(out, "encoder.toy", params.dim_input(c), c["dim_model"])
    params.norm(out, "encoder.toy_norm", c["dim_model"])


def forward(ref, W, x, lengths, gen):
    return ref.ln(W, "encoder.toy_norm", ref.lin(W, "encoder.toy", x), 1e-5)


def flops(c, b, t):
    tt, d_in = roofline.vgg_out(c, t)
    return roofline.lin(b * tt, d_in, c["dim_model"])
'''

# run in the copy alone: its folder first on the path, nothing else of
# the benchmark imported
PROBE = '''
import json, sys
import torch
import torch.nn.functional as F
import roofline
from reference.model import Reference
from reference.params import dim_input, param_shapes
from reference.weights import make_weights

c = json.load(open("configs/flagship.json"))
c.update(encoder_type="toy", dim_model=32, dim_emb=32, num_heads=2,
         dim_key=16, dim_value=16, dim_inner=32, num_dec_layers=1)
shapes = param_shapes(c, 10)
W = make_weights(shapes, 3, "cpu")
ref = Reference(c, "cpu")
audio = torch.randn(2, 4000 + ref.n_fft,
                    generator=torch.Generator().manual_seed(1))
lengths = torch.tensor([4000, 2500])
enc, n_frames = ref.encode(W, audio, lengths)
x = ref.vgg(W, ref.features(audio, lengths)[0])
want = F.layer_norm(x @ W["encoder.toy.weight"].t() + W["encoder.toy.bias"],
                    (32,), W["encoder.toy_norm.weight"],
                    W["encoder.toy_norm.bias"], 1e-5)
print(json.dumps({
    "encoder_leaves": sorted(n for n in shapes if n.startswith("encoder.")),
    "decoder_leaves": sum(n.startswith("decoder.") for n in shapes),
    "d_in": dim_input(c),
    "encode_equal": bool(torch.equal(enc, want)),
    "encode_shape": list(enc.shape),
    "flops": roofline.encoder_flops(c, 2, 800),
    "modules": sorted(m.__file__ for m in list(sys.modules.values())
                      if getattr(m, "__file__", None)
                      and m.__name__.split(".")[0] in
                      ("roofline", "reference")),
}))
'''


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(the copy's folder, what the probe read there)."""
    copy = str(tmp_path_factory.mktemp("toy") / "benchmark")
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(copy, "reference", "encoders", "toy.py"), "w",
              encoding="utf-8") as f:
        f.write(TOY)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=copy,
                         env=dict(os.environ, PYTHONPATH=copy),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return copy, json.loads(out.stdout.strip().splitlines()[-1])


def test_toy_encoder_is_the_only_new_file(toy):
    copy, _ = toy
    for dirpath, dirs, names in os.walk(copy):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), copy)
            if rel == os.path.join("reference", "encoders", "toy.py"):
                continue
            with open(os.path.join(BENCH, rel), "rb") as a, \
                    open(os.path.join(copy, rel), "rb") as b:
                assert a.read() == b.read(), rel


def test_toy_param_shapes(toy):
    _, got = toy
    assert got["encoder_leaves"] == [
        "encoder.toy.bias", "encoder.toy.weight", "encoder.toy_norm.bias",
        "encoder.toy_norm.weight"]
    assert got["decoder_leaves"] > 0  # the decoder is laid out as before


def test_toy_reference_encode(toy):
    _, got = toy
    assert got["encode_equal"]
    assert got["encode_shape"][-1] == 32


def test_toy_encoder_flops(toy):
    copy, got = toy
    assert got["flops"] == 2.0 * (2 * (800 // 4)) * got["d_in"] * 32
    # every module of the yardstick came from the copy
    assert got["modules"] and all(m.startswith(copy) for m in got["modules"])
