"""The traffic generator: every guest of a mix runs the same number of
cycles whatever the seed, pads to the configuration's 2^log_t, and differs
from its neighbours only in its data. Checked on the reference's own
interpreter, which runs each guest as the program's emulator does."""

import os

import pytest

from zkbench import guest
from zkbench.harness import ZKBENCH, load_bench, load_json
from zkbench.reference import rv64

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(ZKBENCH, "traffic")))
SEEDS = (0, 1, 2 ** 31 - 1, 2 ** 31 + 12345, 2 ** 40 + 3)


def _run(elf: bytes):
    run = rv64.run(elf)
    return run, len(run.cycles), run.padded_length


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_runs_the_same_cycles_padded_to_the_cell_size(mix):
    m = guest.load_mix(mix, ZKBENCH)
    runs = [_run(guest.guest_elf(m, 12, s, i))
            for s in SEEDS for i in (-1, 0, 7)]
    assert {n for _, n, _ in runs} == {runs[0][1]}
    assert {p for _, _, p in runs} == {1 << 12}
    assert all(not run.panic for run, _, _ in runs)
    assert runs[0][1] > 0.8 * (1 << 12)


@pytest.mark.parametrize("cell", [w["name"] for w in load_bench()["workloads"]])
def test_each_cell_guest_pads_to_its_configuration(cell):
    w = next(x for x in load_bench()["workloads"] if x["name"] == cell)
    cfg = load_json("configs", f"{w['config']}.json")
    m = guest.load_mix(w["traffic"], ZKBENCH)
    term = rv64.io_layout()["termination"]
    for s in SEEDS[:3]:
        run, _, padded = _run(guest.guest_elf(m, cfg["log_t"], s, 0))
        assert padded == 1 << cfg["log_t"]
        assert any(c.ram_addr == term and c.ram_write == 1
                   for c in run.cycles)


def test_the_seed_and_index_draw_the_data_and_nothing_else():
    m = guest.load_mix("mem", ZKBENCH)
    a = guest.guest_elf(m, 12, 5, 0)
    assert a == guest.guest_elf(m, 12, 5, 0)
    others = {guest.guest_elf(m, 12, 5, 1), guest.guest_elf(m, 12, 6, 0)}
    assert a not in others and len(others) == 2
    assert {len(x) for x in others} == {len(a)}
    outs = {rv64.run(x).outputs for x in others | {a}}
    assert len(outs) == 3


def test_the_mem_mix_reads_and_writes_its_array_each_pass():
    m = guest.load_mix("mem", ZKBENCH)
    run = rv64.run(guest.guest_elf(m, 12, 9, 0))
    base = guest.array_base()
    writes = [c.ram_addr for c in run.cycles
              if base <= c.ram_addr < base + 8 * 2048]
    writes = writes[1::2]               # each pass loads, then stores
    iters = (len(run.cycles) - 30) // 12
    assert iters - 2 <= len(writes) <= iters + 2
    assert len(set(writes)) > len(writes) // 2


def test_the_encoder_matches_the_rv64_fields():
    # addi x1, x0, -1; sd x9, 8(x8); blt x30, x31, -8 (from the ISA manual)
    code = guest.assemble(["top:", "addi x1, x0, -1", "sd x9, 8(x8)",
                           "blt x30, x31, top"])
    words = [int.from_bytes(code[i:i + 4], "little") for i in (0, 4, 8)]
    assert words[0] == 0xFFF00093
    assert words[1] == 0x00943423
    assert words[2] == 0xFFFF4CE3
    with pytest.raises(ValueError):
        guest.assemble(["addi x1, x0, 4096"])


@pytest.mark.parametrize("mix", MIXES)
def test_the_reference_runs_each_guest_as_the_program_does(mix):
    from zolt_tpu_torch.vm import pad_with_noop, run_elf

    m = guest.load_mix(mix, ZKBENCH)
    for s in SEEDS[:2]:
        elf = guest.guest_elf(m, 10, s, 3)
        ref, emu = rv64.run(elf), run_elf(elf)
        assert ref.outputs == bytes(emu.device.outputs)
        assert ref.panic == bool(emu.device.panic)
        assert ref.padded_length == len(pad_with_noop(list(emu.trace)))
        assert [(c.pc, c.ram_addr) for c in ref.cycles] == \
            [(st.pc, st.memory_addr or 0) for st in emu.trace]
