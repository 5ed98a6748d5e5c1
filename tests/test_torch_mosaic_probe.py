"""The port's probe ladder (``ct_mapreduce_tpu_torch/tools/mosaic_probe.py``)
against ``tools/mosaic_probe.py``.

Each plain stage takes the original's random words (``_rows``) and must
equal its NumPy reference ``r_*``; stage 9 takes the original's real
certificates (``_cert_rows``) and must equal its host-parser oracle.
The port's own certificate rows are held to the port's host parser,
and the command line runs the ladder on the CPU. Tolerance: exact
equality.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from ct_mapreduce_tpu_torch.tools import mosaic_probe as tprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", os.path.join(ROOT, "tools", "mosaic_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_names_and_order_follow_the_original(jprobe):
    assert tuple(name for name, _k, _r in jprobe.STAGES) == tprobe.STAGES
    assert (jprobe.LANES, jprobe.WORDS) == (tprobe.LANES, tprobe.WORDS)


@pytest.mark.parametrize("stage", range(9))
def test_plain_stage_matches_numpy_reference(jprobe, stage):
    _name, _kernel, ref = jprobe.STAGES[stage]
    for seed in (0, 1):
        w = jprobe._rows(seed)
        got = tprobe.plain_stage(stage, tprobe.to_tensor(w, "cpu")).numpy()
        np.testing.assert_array_equal(got, ref(w))


def test_serial_stage_matches_host_parser_oracle(jprobe):
    w, oracle = jprobe._cert_rows()
    got = tprobe.plain_stage(tprobe.SERIAL_STAGE, tprobe.to_tensor(w, "cpu"))
    np.testing.assert_array_equal(got.numpy(), oracle)
    w, oracle = tprobe.cert_words()
    got = tprobe.plain_stage(tprobe.SERIAL_STAGE, tprobe.to_tensor(w, "cpu"))
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert len(np.unique(oracle)) > 40


def test_serial_window_model_matches_plain_and_oracle(jprobe):
    """The model of stage 9's kernel (a window of WINDOW_WORDS words,
    reads past it from the row) against the host-parser oracles of both
    certificate corpora and the plain version on random words and on
    crafted rows whose version, serial header or serial runs past the
    window and past the row."""
    for w, oracle in (jprobe._cert_rows(), tprobe.cert_words()):
        got, past = tprobe.serial_window_model(w)
        np.testing.assert_array_equal(got, oracle)
        assert not past.any()  # the window covers the corpus
    for w in (tprobe.random_words(7, 512), tprobe.crafted_serial_rows(7)):
        got, past = tprobe.serial_window_model(w)
        want = tprobe.plain_stage(tprobe.SERIAL_STAGE,
                                  tprobe.to_tensor(w, "cpu")).numpy()
        np.testing.assert_array_equal(got, want)
        assert past.any() and not past.all()


def test_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "ct_mapreduce_tpu_torch.tools.mosaic_probe",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:10]] == [
        ["PASS", f"{name}:"] for name in tprobe.STAGES]
    assert lines[10] == "10/10 stages passed"
