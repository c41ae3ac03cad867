"""zolt-tpu-torch CLI: run / trace / decode / prove / verify / stats / srs /
bench / info.

The command surface of the JAX package's CLI, on the port:
    python -m zolt_tpu_torch run <elf> [--max N] [--regs]
    python -m zolt_tpu_torch trace <elf>
    python -m zolt_tpu_torch decode <hex-instruction>
    python -m zolt_tpu_torch prove <elf> [-o out] [--gzip]
                                   [--legacy [--json] [--log-k N]]
                                   [--jolt-format [--sound]
                                    [--export-preprocessing PATH]
                                    [--device-out PATH] [--timings]
                                    [--stage1-backend device|host|mesh]]
                                   [--backend device|host|mesh]
    python -m zolt_tpu_torch verify <proof> [--elf <elf>] [--inputs HEX]
                                    [--outputs HEX] [--panic]
                                    [--device PATH] [--reference-compat]
                                    [--strict]
    python -m zolt_tpu_torch stats <proof>
    python -m zolt_tpu_torch srs <ptau-or-raw-srs>
    python -m zolt_tpu_torch bench [--quick] [--only SECTIONS]
                                   [--device cuda|cpu] [--elf PATH]
    python -m zolt_tpu_torch info

`prove` writes the internal ZOLT v1 container (zkvm/internal.py, the
reference-parity prover, log_k = 16) by default, the legacy ZOLT v2
container (zkvm/prover.py; JSON with --json; log_k from --log-k, default
10) with --legacy, and the Jolt-format proof with --jolt-format. Each runs
on the GPU unless asked otherwise: --backend defaults to "device"
(device="cuda"), which raises without a CUDA device; --backend host is the
host C tier for the Jolt format, and the kernels' plain torch versions on
the CPU (device="cpu") for the other two. --backend mesh (Jolt format
only) shards the wide rounds over every CUDA device (parallel/mesh.py
make_mesh()). --stage1-backend (Jolt format only) defaults to the value
of --backend. The proof bytes are the same on every tier. `verify` and
`stats` take any of the containers, gzipped or not, routed as the JAX
package's CLI routes them.

Verification is strict by default; --reference-compat opts into the lenient
downgrade that reference-produced proofs need (their stage-5 zero schedule
clobbers the serialized RAF claim); --strict is accepted and does nothing.
--device pins the Fiat-Shamir preamble to a JoltDevice file written at
prove time with --device-out.

`bench` runs the micro-benchmarks of benchmarks.py (the JAX package's
sections) on --device, "cuda" by default (it raises without a CUDA
device; "cpu" runs the kernels' plain torch versions).

Refused with exit code 2 and a message naming it: --backend mesh for the
internal and legacy provers, which have no mesh path (the JAX package's
take no backend).
"""

from __future__ import annotations

import argparse
import sys
import time

STAGE_NAMES = ["stage1 spartan", "stage2 ram-raf", "stage3 lasso",
               "stage4 ram-val", "stage5 registers", "stage6 booleanity"]


def _read_proof(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)
    return data


def _is_internal(data: bytes) -> bool:
    """The internal prover's ZOLT v1 container (the legacy one is v2)."""
    return data[:4] == b"ZOLT" and data[4:8] == b"\x01\x00\x00\x00"


def _device(args):
    """The device the internal and legacy provers run on: "cuda" for
    --backend device, "cpu" (the kernels' plain torch versions) for
    host."""
    if args.backend == "mesh":
        raise NotImplementedError(
            f"the {'legacy' if args.legacy else 'internal'} prover has no "
            f"mesh path (the JAX package's takes no backend); --backend mesh "
            f"is for --jolt-format")
    return "cuda" if args.backend == "device" else "cpu"


def _write(args, data: bytes) -> bytes:
    if args.gzip:
        import gzip

        data = gzip.compress(data, mtime=0)
    with open(args.output, "wb") as f:
        f.write(data)
    return data


def _print_stages(stage_proofs) -> None:
    for name, sp in zip(STAGE_NAMES, stage_proofs):
        n_el = (sum(len(rp) for rp in sp.round_polys) + len(sp.challenges)
                + len(sp.final_claims))
        print(f"  {name:<18} rounds={len(sp.round_polys):>3}  field elements={n_el:>5}"
              f"  ({n_el * 32} bytes)")


def _deserialize_jolt(data: bytes):
    """The proof in the first layout that parses (the CLI writes
    "with_dory"), or None."""
    from .zkvm.jolt_deserialize import deserialize_jolt_proof

    for variant in ("with_dory", "canonical"):
        try:
            return deserialize_jolt_proof(data, variant=variant), variant
        except Exception:
            pass
    return None, None


def _load_and_run(path: str, inputs: bytes = b"", max_cycles: int = 1 << 24):
    from .vm import run_elf

    return run_elf(path, inputs=inputs, max_cycles=max_cycles)


def cmd_run(args) -> int:
    emu = _load_and_run(args.elf, max_cycles=args.max)
    print(f"cycles: {emu.cycle}")
    print(f"a0 (x10): {emu.registers.registers[10]}")
    if args.regs:
        for i in range(32):
            v = emu.registers.registers[i]
            if v:
                print(f"  x{i:<2} = {v:#x}")
    outputs = emu.get_outputs()
    if outputs:
        print(f"outputs: {outputs.hex()}")
    return 0


def cmd_trace(args) -> int:
    from .vm import decode as dec

    emu = _load_and_run(args.elf, max_cycles=args.max)
    for s in emu.trace:
        d = dec.decode(s.instruction)
        print(f"{s.cycle:>6}  pc={s.pc:#010x}  {s.instruction:08x}  "
              f"{d.opcode.name:<10} rd=x{d.rd} rs1=x{d.rs1} rs2=x{d.rs2} imm={d.imm}")
    return 0


def cmd_decode(args) -> int:
    from .vm import decode as dec

    instr = int(args.instruction, 16)
    if dec.is_compressed(instr & 0xFFFF) and instr <= 0xFFFF:
        expanded = dec.expand_compressed(instr)
        print(f"compressed {instr:#06x} -> {expanded:#010x}")
        instr = expanded
    d = dec.decode(instr)
    print(f"opcode={d.opcode.name} format={d.format} rd=x{d.rd} rs1=x{d.rs1} "
          f"rs2=x{d.rs2} funct3={d.funct3:#o} funct7={d.funct7:#x} imm={d.imm}")
    return 0


def cmd_prove(args) -> int:
    if not args.jolt_format:
        return _prove_internal_or_legacy(args)
    from .zkvm.pipeline import prove_jolt

    t0 = time.time()
    # a mesh backend runs on make_mesh(): every CUDA device
    res = prove_jolt(args.elf, with_joint_proof=True, sound=args.sound,
                     stage1_backend=args.stage1_backend, backend=args.backend)
    t1 = time.time()
    data = res.conv.proof.serialize_with_dory()
    if args.gzip:
        import gzip

        data = gzip.compress(data, mtime=0)
    emu, padded = res.emulator, res.padded_steps
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"trace: {emu.cycle} cycles (padded {len(padded)})")
    print(f"prove (jolt-format, 7 stages + Dory): {t1 - t0:.2f}s")
    print(f"proof: {len(data)} bytes -> {args.output}")
    if args.device_out:
        dev_data = emu.device.serialize(preamble_memory_size=32768)
        with open(args.device_out, "wb") as f:
            f.write(dev_data)
        print(f"device: {len(dev_data)} bytes -> {args.device_out}")
    if args.timings:
        from .utils.log import metrics

        print("stage timings:")
        for line in metrics.report_lines():
            print(line)
    if args.export_preprocessing:
        from .vm import elf as elf_mod
        from .vm.layout import MemoryConfig, MemoryLayout
        from .zkvm import preprocessing as prep

        base, image = elf_mod.load_file(args.elf).flat_image()
        layout = MemoryLayout.create(
            MemoryConfig(program_size=len(image), memory_size=32768))
        pp_data = prep.export_preprocessing(
            bytes(image), base, layout, max(1024, len(padded)), srs_log_size=16)
        with open(args.export_preprocessing, "wb") as f:
            f.write(pp_data)
        print(f"preprocessing: {len(pp_data)} bytes -> {args.export_preprocessing}")
    return 0


def _prove_internal_or_legacy(args) -> int:
    """prove --legacy (the ZOLT v2 or JSON container) or the default
    internal ZOLT v1 prover, on the device of --backend."""
    device = _device(args)
    t0 = time.time()
    emu = _load_and_run(args.elf)
    t1 = time.time()
    if args.legacy:
        from . import serialization
        from .zkvm import prove_program

        proof, padded = prove_program(emu, log_k=args.log_k, device=device)
        data = (serialization.to_json(proof).encode() if args.json
                else serialization.serialize(proof))
    else:
        from .vm import elf as elf_mod
        from .vm import pad_with_noop
        from .zkvm.internal import prove_internal

        padded = pad_with_noop(list(emu.trace))
        _, image = elf_mod.load_file(args.elf).flat_image()
        data = prove_internal(emu, padded, bytes(image), log_k=16,
                              device=device).serialize()
    t2 = time.time()
    data = _write(args, data)
    print(f"trace: {emu.cycle} cycles (padded {len(padded)})")
    print(f"emulate: {t1 - t0:.2f}s  prove: {t2 - t1:.2f}s")
    print(f"proof: {len(data)} bytes -> {args.output}")
    return 0


def _verify_internal(data: bytes) -> int:
    from .zkvm.internal import deserialize_internal, verify_internal

    t0 = time.time()
    try:
        verify_internal(deserialize_internal(data))
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"PASSED ({time.time() - t0:.2f}s, format=zolt-internal)")
    return 0


def _verify_legacy(data: bytes) -> int:
    from . import serialization
    from .r1cs import constraints as rc
    from .zkvm import verify
    from .zkvm.stages import _ceil_log2

    try:
        fmt = serialization.detect_format(data)
        proof = (serialization.from_json(data.decode()) if fmt == "json"
                 else serialization.deserialize(data))
    except Exception as e:
        print(f"FAILED: unrecognized proof format ({e})")
        return 1
    ncv = proof.log_t + _ceil_log2(rc.NUM_CONSTRAINTS)
    t0 = time.time()
    try:
        verify(proof, ncv)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"PASSED ({time.time() - t0:.2f}s, format={fmt})")
    return 0


def cmd_verify(args) -> int:
    data = _read_proof(args.proof)
    if _is_internal(data):
        return _verify_internal(data)
    if not args.elf:
        return _verify_legacy(data)
    from .zkvm.jolt_verifier import VerifyError, verify_jolt

    t0 = time.time()
    try:
        proof, _ = _deserialize_jolt(data)
        if proof is None:
            raise VerifyError("unrecognized Jolt proof layout")
        inputs = bytes.fromhex(args.inputs or "")
        outputs = bytes.fromhex(args.outputs or "")
        panic = bool(args.panic)
        memory_size = args.memory_size
        max_input, max_output = args.max_input, args.max_output
        if args.device:
            from .vm.layout import JoltDevice

            with open(args.device, "rb") as f:
                dev = JoltDevice.deserialize(f.read())
            inputs = bytes(dev.inputs)
            outputs = bytes(dev.outputs)
            panic = dev.panic
            memory_size = dev.preamble_memory_size
            max_input = dev.layout.max_input_size
            max_output = dev.layout.max_output_size
        verify_jolt(proof, args.elf, inputs=inputs, outputs=outputs,
                    panic=panic, memory_size=memory_size,
                    max_input_size=max_input, max_output_size=max_output,
                    allow_reference_compat=args.reference_compat)
    except VerifyError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"PASSED ({time.time() - t0:.2f}s, format=jolt-arkworks)")
    return 0


def cmd_stats(args) -> int:
    from . import serialization

    data = _read_proof(args.proof)
    if _is_internal(data):
        from .zkvm.internal import deserialize_internal

        proof = deserialize_internal(data)
        print(f"format: zolt-internal, {len(data)} bytes, log_t={proof.log_t}, log_k={proof.log_k}")
        _print_stages(proof.stage_proofs)
        return 0
    fmt = serialization.detect_format(data)
    if fmt != "unknown":
        proof = (serialization.from_json(data.decode()) if fmt == "json"
                 else serialization.deserialize(data))
        print(f"format: {fmt}, {len(data)} bytes, log_t={proof.log_t}, log_k={proof.log_k}")
        _print_stages(proof.stage_proofs)
        return 0
    proof, variant = _deserialize_jolt(data)
    if proof is None:
        print("unrecognized proof format")
        return 1
    print(f"format: jolt-arkworks ({variant}), {len(data)} bytes")
    print(f"trace_length={proof.trace_length}, ram_K={proof.ram_k}, "
          f"bytecode_K={proof.bytecode_k}")
    print(f"commitments: {len(proof.commitments)} GT elements "
          f"({len(proof.commitments) * 384} bytes)")
    print(f"opening claims: {len(proof.opening_claims)}")
    stages = [("stage1 uniskip", proof.stage1_uni_skip.uni_poly),
              ("stage2 uniskip", proof.stage2_uni_skip.uni_poly)]
    for i in range(1, 8):
        sc = getattr(proof, f"stage{i}_sumcheck")
        n_el = sum(len(cp) for cp in sc.compressed_polys)
        print(f"  stage{i} sumcheck   rounds={len(sc.compressed_polys):>3}"
              f"  field elements={n_el:>5}  ({n_el * 32} bytes)")
    for name, poly in stages:
        print(f"  {name:<17} coeffs={len(poly):>3}  ({len(poly) * 32} bytes)")
    return 0


def cmd_srs(args) -> int:
    """Inspect a PTAU ceremony file or raw SRS (reference main.zig:804-880)."""
    from .pcs import srs as srs_mod

    with open(args.file, "rb") as f:
        data = f.read()
    size_mb = len(data) / (1024 * 1024)
    print("SRS File Inspector")
    print("==================")
    print(f"File: {args.file} ({len(data)} bytes, {size_mb:.2f} MB)")
    if data[:4] == srs_mod.PTAU_MAGIC:
        srs = srs_mod.load_ptau(data)
        print("Format: snarkjs PTAU v1")
        print(f"  Power: 2^{srs.power} = {1 << srs.power} points")
        print(f"  Ceremony power: 2^{srs.ceremony_power}")
        print(f"  G1 points: {len(srs.powers_of_tau_g1)}")
        print(f"  G2 points: {len(srs.powers_of_tau_g2)}")
        print(f"  Alpha*tau G1: {len(srs.alpha_tau_g1 or [])}")
        print(f"  Beta*tau G1: {len(srs.beta_tau_g1 or [])}")
        if srs.powers_of_tau_g1:
            g1 = srs.powers_of_tau_g1[0]
            print(f"First G1 point: x={g1[0]:#066x}")
            print(f"                y={g1[1]:#066x}")
            print("on curve:", (g1[1]**2 - g1[0]**3 - 3) % srs_mod.FP.p == 0)
        return 0
    try:
        srs = srs_mod.load_raw_binary(data)
        print("Format: zolt raw binary")
        print(f"  G1 powers: {len(srs.powers_g1)}")
        print(f"  tau_g2 x0: {srs.tau_g2[0][0]:#x}")
        return 0
    except Exception as e:
        print(f"Unrecognized SRS format: {e}")
        return 1


def cmd_bench(args) -> int:
    from .benchmarks import run_benchmarks

    sections = set(args.only.split(",")) if args.only else None
    run_benchmarks(sections=sections, quick=args.quick, device=args.device,
                   elf=args.elf)
    return 0


def cmd_info(args) -> int:
    import torch

    from . import __version__

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    print(f"zolt-tpu-torch {__version__}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"CUDA devices: {n} {names}")
    print("BN254 Jolt-style zkVM prover, PyTorch with hand-written CUDA "
          "kernels for Hopper (sm_90a)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zolt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run an ELF in the emulator")
    pr.add_argument("elf")
    pr.add_argument("--max", type=int, default=1 << 24)
    pr.add_argument("--regs", action="store_true")
    pr.set_defaults(fn=cmd_run)

    pt = sub.add_parser("trace", help="print the execution trace")
    pt.add_argument("elf")
    pt.add_argument("--max", type=int, default=1 << 24)
    pt.set_defaults(fn=cmd_trace)

    pd = sub.add_parser("decode", help="decode a hex instruction")
    pd.add_argument("instruction")
    pd.set_defaults(fn=cmd_decode)

    pp = sub.add_parser("prove", help="prove an ELF execution")
    pp.add_argument("elf")
    pp.add_argument("-o", "--output", default="proof.bin")
    pp.add_argument("--json", action="store_true",
                    help="with --legacy: write the JSON container")
    pp.add_argument("--log-k", type=int, default=10,
                    help="with --legacy: log2 of the RAM address space "
                    "(default 10)")
    pp.add_argument("--jolt-format", action="store_true",
                    help="emit the Jolt-compatible arkworks proof (Dory "
                    "commitments)")
    pp.add_argument("--export-preprocessing", metavar="PATH",
                    help="write the Jolt verifier preprocessing file")
    pp.add_argument("--legacy", action="store_true",
                    help="emit the device-accelerated legacy container")
    pp.add_argument("--sound", action="store_true",
                    help="with --jolt-format: sound-mode stages 5-12 and the "
                    "PCS batch opening (strictly verifiable, not "
                    "byte-compatible with the reference)")
    pp.add_argument("--gzip", action="store_true",
                    help="gzip-wrap the proof container (autodetected by verify)")
    pp.add_argument("--device-out", metavar="PATH",
                    help="write the JoltDevice (I/O claim) file after proving, "
                    "for preamble pinning at verify time")
    pp.add_argument("--timings", action="store_true",
                    help="print the per-stage metrics registry after proving")
    pp.add_argument("--backend", choices=("device", "host", "mesh"),
                    default="device",
                    help="device (the default): the wide sumcheck rounds and "
                    "the MSMs on the CUDA device, which must be present; "
                    "host: the host C tier (Jolt format) or the kernels' plain "
                    "torch versions on the CPU (the internal and legacy "
                    "provers); mesh: the Jolt format's wide rounds sharded "
                    "over every CUDA device")
    pp.add_argument("--stage1-backend", choices=("device", "host", "mesh"),
                    default=None,
                    help="where stage 1's remaining rounds run (default: as "
                    "--backend); the proof bytes are the same")
    pp.set_defaults(fn=cmd_prove)

    pv = sub.add_parser("verify", help="verify a proof")
    pv.add_argument("proof")
    pv.add_argument("--elf", help="program ELF: verify a Jolt-format "
                    "(arkworks) proof against this program")
    pv.add_argument("--inputs", help="program input bytes (hex)")
    pv.add_argument("--outputs", help="claimed program output bytes (hex) — "
                    "part of the Fiat-Shamir preamble")
    pv.add_argument("--panic", action="store_true",
                    help="the claimed execution panicked (preamble bit)")
    pv.add_argument("--memory-size", type=int, default=32768)
    pv.add_argument("--max-input", type=int, default=4096)
    pv.add_argument("--max-output", type=int, default=4096)
    pv.add_argument("--device", metavar="PATH",
                    help="JoltDevice file pinning the preamble I/O claim "
                    "(overrides --inputs/--outputs/--panic and size knobs)")
    pv.add_argument("--reference-compat", action="store_true",
                    help="allow the lenient downgrade needed by reference-"
                    "produced proofs (skips the stage-3 full output check)")
    pv.add_argument("--strict", action="store_true",
                    help="deprecated: strict is now the default; use "
                    "--reference-compat to opt into the lenient mode")
    pv.set_defaults(fn=cmd_verify)

    ps = sub.add_parser("stats", help="proof statistics")
    ps.add_argument("proof")
    ps.set_defaults(fn=cmd_stats)

    psrs = sub.add_parser("srs", help="inspect a PTAU/raw SRS file")
    psrs.add_argument("file")
    psrs.set_defaults(fn=cmd_srs)

    pb = sub.add_parser("bench", help="run micro-benchmarks")
    pb.add_argument("--quick", action="store_true", help="smaller sizes")
    pb.add_argument("--only", help="comma-separated sections "
                    "(field,poly,msm,commit,emulator,prover,scaling,"
                    "roofline,mesh,e2e,chipcheck)")
    pb.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a CUDA device) "
                    "or cpu (the kernels' plain torch versions)")
    pb.add_argument("--elf", default=None,
                    help="the guest the prover section proves (without "
                    "one, the section skips)")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="version and device info")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        print(f"zolt_tpu_torch {args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
