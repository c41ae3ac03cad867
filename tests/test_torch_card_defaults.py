"""The port's MSM and HyperKZG entry points run on the card unless asked
otherwise: `msm.msm` and `pcs.hyperkzg`'s commit_ints, open_at,
batch_commit and batch_open default to device="cuda". Where there is no
CUDA device a default call raises (nothing falls back to the CPU) before
it touches the transcript; device=None keeps the host tiers. With a card,
the default call's result equals the host tiers'. Under a second on an
8-core CPU box.
"""

import pytest
import torch

from zolt_tpu_torch.curve import host
from zolt_tpu_torch.msm import msm
from zolt_tpu_torch.pcs import hyperkzg, srs
from zolt_tpu_torch.transcript import Blake2bTranscript

SETUP = srs.insecure_setup(8)
POLYS = [[3, 1, 4, 1], [5, 9, 2, 6]]
X = [7, 11]

CALLS = {
    "msm": lambda **kw: msm(host.random_points(4), [1, 2, 3, 4], **kw),
    "commit_ints": lambda **kw: hyperkzg.commit_ints(SETUP, POLYS[0], **kw),
    "open_at": lambda **kw: hyperkzg.open_at(
        SETUP, POLYS[0], X, Blake2bTranscript(b"d"), **kw).com,
    "batch_commit": lambda **kw: hyperkzg.batch_commit(SETUP, POLYS, **kw),
    "batch_open": lambda **kw: hyperkzg.batch_open(
        SETUP, POLYS, X, Blake2bTranscript(b"d"), **kw).evaluations,
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_default_runs_on_the_card_or_raises(name):
    call = CALLS[name]
    host_tiers = call(device=None)
    if torch.cuda.is_available():
        assert call() == host_tiers
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_a_default_open_raises_before_it_absorbs():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the open runs on it")
    t = Blake2bTranscript(b"d")
    before = t.state
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hyperkzg.batch_open(SETUP, POLYS, X, t)
    assert t.state == before
