from . import decode, elf, emulator, layout, state
from .emulator import Emulator, TraceStep, pad_with_noop, run_elf
from .layout import JoltDevice, MemoryConfig, MemoryLayout, RAM_START_ADDRESS

__all__ = [
    "decode", "elf", "emulator", "layout", "state",
    "Emulator", "TraceStep", "pad_with_noop", "run_elf",
    "JoltDevice", "MemoryConfig", "MemoryLayout", "RAM_START_ADDRESS",
]
