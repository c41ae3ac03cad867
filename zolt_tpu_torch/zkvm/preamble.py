"""Jolt Fiat-Shamir preamble (byte-exact).

Absorb order (reference src/zkvm/jolt_device.zig:308-360): max_input_size,
max_output_size, memory_size as u64; inputs and outputs as raw bytes; panic,
ram_K, trace_length as u64. Golden vector: the reference's fibonacci run
(logs/zolt.log:1163-1188) with (4096, 4096, 32768, b"", b"", 0, 65536, 256)
leaves the transcript state at cf cf 19 f2 ff b0 c7 21 ...
"""

from __future__ import annotations


def fiat_shamir_preamble(transcript, *, max_input_size: int, max_output_size: int,
                         memory_size: int, inputs: bytes, outputs: bytes,
                         panic: bool, ram_k: int, trace_length: int) -> None:
    transcript.append_u64(max_input_size)
    transcript.append_u64(max_output_size)
    transcript.append_u64(memory_size)
    transcript.append_bytes(bytes(inputs))
    transcript.append_bytes(bytes(outputs))
    transcript.append_u64(1 if panic else 0)
    transcript.append_u64(ram_k)
    transcript.append_u64(trace_length)


def preamble_from_device(transcript, device, ram_k: int, trace_length: int) -> None:
    fiat_shamir_preamble(
        transcript,
        max_input_size=device.layout.max_input_size,
        max_output_size=device.layout.max_output_size,
        memory_size=device.layout.memory_size,
        inputs=bytes(device.inputs),
        outputs=bytes(device.outputs),
        panic=device.panic,
        ram_k=ram_k,
        trace_length=trace_length,
    )
