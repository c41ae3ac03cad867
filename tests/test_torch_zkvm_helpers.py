"""The port's copies of the JAX package's small public zkvm helpers:
raf_gadgets.gadget_eval_bits, and commitments.build_ram_ra,
build_ram_ra_onehot and build_bytecode_ra, held to JAX's on the same
inputs. gadget_eval_bits runs every gadget kind, and every lookup table,
at random 128-bit indices and at the edges; the builders run on the
traces of the repository bench's sum-loop guest (T = 2^10, no RAM
access) and of the golden array guest (loads and stores), each emulated
by each package's own emulator, at every chunk shift, and their FrVec
values must be equal. A few seconds on an 8-core CPU box.
"""

import numpy as np
import pytest

import chip_smoke
from golden_programs import _golden_array
from zolt_tpu.vm import pad_with_noop as jax_pad
from zolt_tpu.vm import run_elf as jax_run_elf
from zolt_tpu.vm.tables import Table as JaxTable
from zolt_tpu.zkvm import commitments as jax_com
from zolt_tpu.zkvm import raf_gadgets as jax_raf
from zolt_tpu_torch.vm import RAM_START_ADDRESS, pad_with_noop, run_elf
from zolt_tpu_torch.vm.tables import Table
from zolt_tpu_torch.zkvm import commitments, raf_gadgets


def _indices(seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, (1 << 64) - 1, 1 << 64, (1 << 128) - 1,
             0x5555 << 60, 0xAAAA << 62]
    return edges + [int.from_bytes(rng.bytes(16), "little")
                    for _ in range(24)]


@pytest.mark.parametrize("kind", [g for g in raf_gadgets.G
                                  if g != raf_gadgets.G.TABLE])
def test_gadget_eval_bits_matches_jax(kind):
    for const in (0, 7, raf_gadgets.P - 1):
        slot = raf_gadgets.Slot(kind, const)
        jslot = jax_raf.Slot(jax_raf.G(int(kind)), const)
        for idx in _indices(int(kind)):
            assert raf_gadgets.gadget_eval_bits(slot, idx) == \
                jax_raf.gadget_eval_bits(jslot, idx), (kind, const, idx)


def test_gadget_eval_bits_of_every_table_matches_jax():
    for table in Table:
        slot = raf_gadgets.Slot(raf_gadgets.G.TABLE, 3, table)
        jslot = jax_raf.Slot(jax_raf.G.TABLE, 3, JaxTable(int(table)))
        for idx in _indices(100 + int(table)):
            assert raf_gadgets.gadget_eval_bits(slot, idx) == \
                jax_raf.gadget_eval_bits(jslot, idx), (table, idx)


def _golden_array_elf() -> bytes:
    from zolt_tpu.vm import elf as elf_mod
    from zolt_tpu.vm.layout import MemoryConfig, MemoryLayout

    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = _golden_array(lay)
    a.halt(lay, tmp=30, one=31, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


@pytest.fixture(scope="module", params=["sum_loop_t10", "golden_array"])
def traces(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("guest") / "guest.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(10) if request.param == "sum_loop_t10"
                else _golden_array_elf())
    return (pad_with_noop(list(run_elf(path).trace)),
            jax_pad(list(jax_run_elf(path).trace)))


@pytest.mark.parametrize("builder", ["build_ram_ra", "build_bytecode_ra"])
def test_ra_builders_match_jax(traces, builder):
    steps, jsteps = traces
    size = len(steps)
    for shift in range(0, 64, commitments.LOG_K_CHUNK):
        got = getattr(commitments, builder)(steps, size, shift)
        want = getattr(jax_com, builder)(jsteps, size, shift)
        assert got.to_ints() == want.to_ints(), (builder, shift)


def test_build_ram_ra_onehot_matches_jax(traces):
    steps, jsteps = traces
    size = len(steps)
    for log_ram_k in (10, 16):
        for shift in range(0, log_ram_k, commitments.LOG_K_CHUNK):
            got = commitments.build_ram_ra_onehot(
                steps, size, shift, RAM_START_ADDRESS, log_ram_k)
            want = jax_com.build_ram_ra_onehot(
                jsteps, size, shift, RAM_START_ADDRESS, log_ram_k)
            assert got.n == want.n == (1 << commitments.LOG_K_CHUNK) * size
            assert got.to_ints() == want.to_ints(), (log_ram_k, shift)
