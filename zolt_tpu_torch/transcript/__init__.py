from .blake2b import Blake2bTranscript
from .keccak import KeccakTranscript, keccak_f
from .poseidon import PoseidonTranscript

__all__ = ["Blake2bTranscript", "KeccakTranscript", "keccak_f",
           "PoseidonTranscript"]
