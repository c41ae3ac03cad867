"""Minimal ELF32/ELF64 loader for RISC-V guests.

Parses the header + program headers and extracts PT_LOAD segments and the
entry point (reference: src/host/elf.zig:89-260). Little-endian only.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

EM_RISCV = 243
PT_LOAD = 1


@dataclass
class Segment:
    vaddr: int
    data: bytes
    memsz: int


@dataclass
class ParsedElf:
    entry: int
    segments: list[Segment]
    is_64: bool
    machine: int

    def flat_image(self) -> tuple[int, bytes]:
        """(base_vaddr, contiguous image) spanning all PT_LOAD segments,
        zero-filled between them."""
        base = min(s.vaddr for s in self.segments)
        end = max(s.vaddr + max(s.memsz, len(s.data)) for s in self.segments)
        img = bytearray(end - base)
        for s in self.segments:
            img[s.vaddr - base : s.vaddr - base + len(s.data)] = s.data
        return base, bytes(img)


def parse(data: bytes) -> ParsedElf:
    assert data[:4] == b"\x7fELF", "not an ELF file"
    ei_class = data[4]
    ei_data = data[5]
    assert ei_data == 1, "big-endian ELF unsupported"
    is_64 = ei_class == 2

    if is_64:
        (e_type, e_machine, e_version, e_entry, e_phoff, _shoff, _flags, _ehsize,
         e_phentsize, e_phnum) = struct.unpack_from("<HHIQQQIHHH", data, 16)
    else:
        (e_type, e_machine, e_version, e_entry, e_phoff, _shoff, _flags, _ehsize,
         e_phentsize, e_phnum) = struct.unpack_from("<HHIIIIIHHH", data, 16)

    segments = []
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        if is_64:
            p_type, p_flags, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, _align = (
                struct.unpack_from("<IIQQQQQQ", data, off)
            )
        else:
            p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, p_flags, _align = (
                struct.unpack_from("<IIIIIIII", data, off)
            )
        if p_type == PT_LOAD:
            segments.append(Segment(p_vaddr, data[p_offset : p_offset + p_filesz], p_memsz))

    return ParsedElf(entry=e_entry, segments=segments, is_64=is_64, machine=e_machine)


def load_file(path: str) -> ParsedElf:
    with open(path, "rb") as f:
        return parse(f.read())


def write_minimal_elf(code: bytes, base: int = 0x80000000,
                      entry: int | None = None) -> bytes:
    """Emit a minimal ELF64 RISC-V executable with one PT_LOAD segment.

    The inverse of `parse` for the subset this loader consumes — lets
    Asm-authored guest programs (vm/guest.Asm) flow through every path that
    takes an ELF (CLI run/trace/prove, prove_jolt, verify_jolt) instead of
    only the reference's prebuilt examples.
    """
    if entry is None:
        entry = base
    ehsize, phentsize = 64, 56
    phoff = ehsize
    data_off = ehsize + phentsize
    ehdr = struct.pack(
        "<4sBBBBB7xHHIQQQIHHHHHH",
        b"\x7fELF", 2, 1, 1, 0, 0,     # ELF64, little-endian, SysV
        2, EM_RISCV, 1,                 # ET_EXEC, RISC-V, version
        entry, phoff, 0,                # e_entry, e_phoff, e_shoff
        0, ehsize, phentsize, 1,        # e_flags, e_ehsize, e_phentsize, e_phnum
        0, 0, 0)                        # shentsize/shnum/shstrndx
    phdr = struct.pack(
        "<IIQQQQQQ",
        PT_LOAD, 5,                     # p_type, p_flags (R+X)
        data_off, base, base,           # p_offset, p_vaddr, p_paddr
        len(code), len(code), 0x1000)   # p_filesz, p_memsz, p_align
    return ehdr + phdr + code
