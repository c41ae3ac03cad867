"""A plain verifier of Jolt-format compat proofs, and the reference's own
values of the claims that a proof makes about an execution.

It shares no code with the program. It is written from Jolt's protocol as
upstream zolt's compat mode emits it (src/zkvm/proof_converter.zig): the
arkworks container, the Blake2b transcript (src/transcripts/blake2b.zig), the
preamble (src/zkvm/jolt_device.zig), Spartan's outer sumcheck with its
univariate skip over Jolt's 19 uniform R1CS constraints (src/zkvm/r1cs/), the
product-virtualization skip, the batched stage-2 sumcheck and the zero
stages 5-7.

`check` enforces what a compat proof lets any verifier enforce:

- the container parses to its end, with the trace length and RAM K stated;
- the transcript, replayed from the public I/O and every GT commitment,
  derives the challenges through stage 2's last round;
- stage 1: the first-round polynomial vanishes on the base domain (every
  constraint holds on every cycle), its value at r0 is the claimed one, and
  the final claim equals eq(tau, r) * Az(r) * Bz(r) with Az and Bz made from
  the 36 claimed inputs through the 19 constraints;
- stage 2's skip: on the base domain, the polynomial is the Lagrange kernel
  times each of the five product claims;
- round counts and shapes of stages 2-7, and stages 5-7 all zero.

Past stage 2's last round a compat proof cannot be replayed: upstream's
compat mode serializes the RAM RAF claim as 0 after the transcript took the
real one, and its stage-2 RAM checking instances carry no public final. So
`execution_claims` recomputes, from the reference's own run of the guest, the
claims that pin what was proved to this execution: the stage-1 columns of the
instruction addresses, the register writes and the RAM accesses at the
stage-1 point, and the initial and final RAM at the stage-2 output point.
"""

from __future__ import annotations

import hashlib
import struct

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
INV_2_128 = pow(1 << 128, -1, P)

# -- the Blake2b transcript --------------------------------------------------


class Transcript:
    """Jolt's Blake2bTranscript: a 32-byte state and a round counter; every
    absorb and squeeze hashes state || 28 zero bytes || round (big-endian)."""

    def __init__(self, label: bytes):
        self.state = hashlib.blake2b(label.ljust(32, b"\0"),
                                     digest_size=32).digest()
        self.rounds = 0

    def _hash(self, payload: bytes = b"") -> bytes:
        h = hashlib.blake2b(digest_size=32)
        h.update(self.state + self.rounds.to_bytes(32, "big") + payload)
        self.state = h.digest()
        self.rounds += 1
        return self.state

    def message(self, m: bytes) -> None:
        self._hash(m.ljust(32, b"\0"))

    def raw(self, b: bytes) -> None:
        self._hash(b)

    def u64(self, v: int) -> None:
        self._hash(v.to_bytes(32, "big"))

    def scalar(self, v: int) -> None:
        self._hash((v % P).to_bytes(32, "big"))

    def gt(self, b: bytes) -> None:
        self._hash(b[::-1])

    def challenge(self) -> int:
        """The 125-bit challenge, whose bits Jolt reads as Montgomery limbs."""
        v = int.from_bytes(self._hash()[:16][::-1], "big") & ((1 << 125) - 1)
        return v * INV_2_128 % P

    def challenge_full(self) -> int:
        return int.from_bytes(self._hash()[:16], "big") % P


# -- the container -----------------------------------------------------------

N_SUMCHECK_IDS = 22
SPARTAN_OUTER, PRODUCT_VIRT, RAM_OUTPUT = 0, 1, 9
# virtual polynomial tags (jolt_types: VirtualPolynomial)
V = {"PC": 0, "UnexpandedPC": 1, "NextPC": 2, "NextUnexpandedPC": 3,
     "NextIsNoop": 4, "NextIsVirtual": 5, "NextIsFirstInSequence": 6,
     "LeftLookupOperand": 7, "RightLookupOperand": 8,
     "LeftInstructionInput": 9, "RightInstructionInput": 10, "Product": 11,
     "ShouldJump": 12, "ShouldBranch": 13, "WritePCtoRD": 14,
     "WriteLookupOutputToRD": 15, "Imm": 17, "Rs1Value": 18, "Rs2Value": 19,
     "RdWriteValue": 20, "LookupOutput": 24, "RamAddress": 29, "RamRa": 30,
     "RamReadValue": 31, "RamWriteValue": 32, "RamVal": 33, "RamValInit": 34,
     "RamValFinal": 35, "UnivariateSkip": 37, "OpFlags": 38,
     "InstructionFlags": 39}
VIRTUAL_PAYLOAD = (27, 38, 39, 40)
COMMITTED_PAYLOAD = (2, 3, 4)


class Reject(Exception):
    pass


def need(cond: bool, why: str) -> None:
    if not cond:
        raise Reject(why)


class _Bytes:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        need(self.pos + n <= len(self.data), "the proof ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def fr(self) -> int:
        v = int.from_bytes(self.take(32), "little")
        need(v < P, "a scalar is not reduced")
        return v

    def frs(self, n: int) -> list[int]:
        need(n < 1 << 20, "a length is out of range")
        return [self.fr() for _ in range(n)]


def parse(blob: bytes) -> dict:
    """The compat container: claims keyed (kind, tag, index, sumcheck id),
    the GT commitments, the two skip polynomials, the seven sumchecks (each
    a list of compressed round polynomials) and the configuration tail."""
    r = _Bytes(blob)
    claims = {}
    for _ in range(r.u64()):
        d = r.u8()
        need(d >= 2 * N_SUMCHECK_IDS, "advice openings are not in compat proofs")
        kind = "c" if d < 3 * N_SUMCHECK_IDS else "v"
        sid = d - (2 if kind == "c" else 3) * N_SUMCHECK_IDS
        tag = r.u8()
        payload = COMMITTED_PAYLOAD if kind == "c" else VIRTUAL_PAYLOAD
        idx = r.u8() if tag in payload else 0
        key = (kind, tag, idx, sid)
        need(key not in claims, "a claim appears twice")
        claims[key] = r.fr()
    out = {"claims": claims,
           "commitments": [r.take(384) for _ in range(r.u64())]}
    out["skip1"] = r.frs(r.u64())
    out["stages"] = {}
    for stage in range(1, 8):
        if stage == 2:
            out["skip2"] = r.frs(r.u64())
        out["stages"][stage] = [r.frs(r.u64()) for _ in range(r.u64())]
    need(r.u8() == 0, "compat proofs carry no advice commitment")
    out["trace_length"], out["ram_k"], out["bytecode_k"] = (r.u64(), r.u64(),
                                                           r.u64())
    out["rw_config"] = tuple(r.take(4))
    out["one_hot"] = tuple(r.take(2))
    out["dory_layout"] = r.u8()
    need(r.pos == len(blob), "bytes after the configuration: a compat proof "
         "has no opening or lookups section")
    return out


def claim(proof: dict, name: str, sid: int, idx: int = 0) -> int:
    key = ("v", V[name], idx, sid)
    need(key in proof["claims"], f"missing claim {name}@{sid}")
    return proof["claims"][key]


# -- polynomials -------------------------------------------------------------


def horner(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def lagrange(n: int, x: int) -> list[int]:
    """The Lagrange basis at x over the symmetric domain of n integers that
    starts at -((n - 1) // 2)."""
    pts = [j - (n - 1) // 2 for j in range(n)]
    out = []
    for i, xi in enumerate(pts):
        num = den = 1
        for j, xj in enumerate(pts):
            if j != i:
                num = num * (x - xj) % P
                den = den * (xi - xj) % P
        out.append(num * pow(den, -1, P) % P)
    return out


def kernel(n: int, x: int, y: int) -> int:
    return sum(a * b for a, b in zip(lagrange(n, x), lagrange(n, y))) % P


def eq1(a: int, b: int) -> int:
    return (a * b + (1 - a) * (1 - b)) % P


def eq_table(point: list[int]) -> list[int]:
    """eq(point, t) for every t, with point[0] the most significant bit."""
    table = [1]
    for x in point:
        table = [v * f % P for v in table for f in ((1 - x) % P, x)]
    return table


def sumcheck(tp: Transcript, rounds: list[list[int]], claim_: int,
             degree: int = 3) -> tuple[int, list[int]]:
    """Replay compressed rounds (every coefficient but the linear one, which
    the running claim fixes through p(0) + p(1) = claim)."""
    rs = []
    for c in rounds:
        need(len(c) == degree, "a round polynomial has the wrong degree")
        tp.message(b"UniPoly_begin")
        for v in c:
            tp.scalar(v)
        tp.message(b"UniPoly_end")
        r = tp.challenge()
        rs.append(r)
        full = [c[0], (claim_ - 2 * c[0] - sum(c[1:])) % P] + c[1:]
        claim_ = horner(full, r)
    return claim_, rs


def skip_challenge(tp: Transcript, coeffs: list[int]) -> int:
    tp.message(b"UncompressedUniPoly_begin")
    for v in coeffs:
        tp.scalar(v)
    tp.message(b"UncompressedUniPoly_end")
    return tp.challenge()


# -- the R1CS of one cycle ----------------------------------------------------

# Spartan's 36 inputs in the order the proof absorbs them; OpFlags(i) are
# Jolt's circuit flags.
INPUTS = ["LeftInstructionInput", "RightInstructionInput", "Product",
          "WriteLookupOutputToRD", "WritePCtoRD", "ShouldBranch", "PC",
          "UnexpandedPC", "Imm", "RamAddress", "Rs1Value", "Rs2Value",
          "RdWriteValue", "RamReadValue", "RamWriteValue", "LeftLookupOperand",
          "RightLookupOperand", "NextUnexpandedPC", "NextPC", "NextIsVirtual",
          "NextIsFirstInSequence", "LookupOutput", "ShouldJump"]
FLAGS = ["AddOperands", "SubtractOperands", "MultiplyOperands", "Load",
         "Store", "Jump", "WriteLookupOutputToRD", "VirtualInstruction",
         "Assert", "DoNotUpdateUnexpandedPC", "Advice", "IsCompressed",
         "IsFirstInSequence"]


def constraints(w: dict) -> list[tuple[int, int]]:
    """Jolt's 19 uniform constraints as (guard, left - right) over one
    assignment, in Jolt's order (r1cs/constraints.rs)."""
    f = lambda n: w["flag." + n]       # noqa: E731
    ld_st = f("Load") + f("Store")
    arith = f("AddOperands") + f("SubtractOperands") + f("MultiplyOperands")
    return [
        (ld_st, w["RamAddress"] - w["Rs1Value"] - w["Imm"]),
        (1 - ld_st, w["RamAddress"]),
        (f("Load"), w["RamReadValue"] - w["RamWriteValue"]),
        (f("Load"), w["RamReadValue"] - w["RdWriteValue"]),
        (f("Store"), w["Rs2Value"] - w["RamWriteValue"]),
        (arith, w["LeftLookupOperand"]),
        (1 - arith, w["LeftLookupOperand"] - w["LeftInstructionInput"]),
        (f("AddOperands"), w["RightLookupOperand"] - w["LeftInstructionInput"]
         - w["RightInstructionInput"]),
        (f("SubtractOperands"), w["RightLookupOperand"] - w["LeftInstructionInput"]
         + w["RightInstructionInput"] - (1 << 64)),
        (f("MultiplyOperands"), w["RightLookupOperand"] - w["Product"]),
        (1 - arith - f("Advice"),
         w["RightLookupOperand"] - w["RightInstructionInput"]),
        (f("Assert"), w["LookupOutput"] - 1),
        (w["WriteLookupOutputToRD"], w["RdWriteValue"] - w["LookupOutput"]),
        (w["WritePCtoRD"], w["RdWriteValue"] - w["UnexpandedPC"] - 4
         + 2 * f("IsCompressed")),
        (w["ShouldJump"], w["NextUnexpandedPC"] - w["LookupOutput"]),
        (w["ShouldBranch"], w["NextUnexpandedPC"] - w["UnexpandedPC"] - w["Imm"]),
        (1 - w["ShouldBranch"] - f("Jump"),
         w["NextUnexpandedPC"] - w["UnexpandedPC"] - 4
         + 4 * f("DoNotUpdateUnexpandedPC") + 2 * f("IsCompressed")),
        (f("VirtualInstruction"), w["NextPC"] - w["PC"] - 1),
        (w["NextIsVirtual"] - w["NextIsFirstInSequence"],
         1 - f("DoNotUpdateUnexpandedPC")),
    ]


# the univariate skip's two groups of constraints, in domain order
GROUPS = ([1, 2, 3, 4, 5, 6, 11, 14, 17, 18], [0, 7, 8, 9, 10, 12, 13, 15, 16])
OUTER_DOMAIN, PRODUCT_DOMAIN = 10, 5
PRODUCTS = ["Product", "WriteLookupOutputToRD", "WritePCtoRD", "ShouldBranch",
            "ShouldJump"]
LOG_REGISTERS = 7


# -- the verifier ------------------------------------------------------------


def check(blob: bytes, *, outputs: bytes, panic: bool, memory_size: int,
          log_ram_k: int, trace_length: int) -> dict:
    """Raise Reject where the compat proof fails; else return the parsed
    proof with the challenges that `execution_claims` reads."""
    try:
        proof = parse(blob)
    except Reject:
        raise
    except Exception as e:          # a malformed container
        raise Reject(f"unparsable: {type(e).__name__}: {e}") from e
    n = trace_length.bit_length() - 1
    need(proof["trace_length"] == trace_length,
         f"trace length {proof['trace_length']}, the run's {trace_length}")
    need(proof["ram_k"] == 1 << log_ram_k, f"RAM K {proof['ram_k']}")
    need(proof["rw_config"][:2] == (n // 2, log_ram_k),
         f"RAM read-write schedule {proof['rw_config']}")

    tp = Transcript(b"Jolt")
    for v in (4096, 4096, memory_size):
        tp.u64(v)
    tp.raw(b"")                     # no inputs
    tp.raw(outputs)
    for v in (int(panic), proof["ram_k"], proof["trace_length"]):
        tp.u64(v)
    need(proof["commitments"], "no commitments")
    for c in proof["commitments"]:
        tp.gt(c)
    tau = [tp.challenge() for _ in range(n + 2)]

    # stage 1: the outer sumcheck after its univariate skip
    s1 = proof["skip1"]
    need(len(s1) == 3 * (OUTER_DOMAIN - 1) + 1, "stage-1 skip degree")
    base = [j - (OUTER_DOMAIN - 1) // 2 for j in range(OUTER_DOMAIN)]
    need(all(horner(s1, y % P) == 0 for y in base),
         "stage-1 skip polynomial is not zero on the base domain")
    r0 = skip_challenge(tp, s1)
    skip_claim = horner(s1, r0)
    need(claim(proof, "UnivariateSkip", SPARTAN_OUTER) == skip_claim,
         "stage-1 skip claim")
    tp.scalar(skip_claim)
    tp.scalar(skip_claim)
    alpha = tp.challenge_full()
    rounds = proof["stages"][1]
    need(len(rounds) == n + 1, "stage-1 round count")
    final, r1 = sumcheck(tp, rounds, alpha * skip_claim % P)
    w = {}
    for name in INPUTS:
        w[name] = claim(proof, name, SPARTAN_OUTER)
    for i, name in enumerate(FLAGS):
        w["flag." + name] = claim(proof, "OpFlags", SPARTAN_OUTER, i)
    for name in INPUTS:
        tp.scalar(w[name])
    for name in FLAGS:
        tp.scalar(w["flag." + name])
    eq = kernel(OUTER_DOMAIN, r0, tau[-1])
    for i, r in enumerate(r1):
        eq = eq * eq1(tau[n - i], r) % P
    lag = lagrange(OUTER_DOMAIN, r0)
    rows = constraints(w)
    az, bz = [], []
    for group in GROUPS:
        az.append(sum(lag[t] * rows[c][0] for t, c in enumerate(group)) % P)
        bz.append(sum(lag[t] * rows[c][1] for t, c in enumerate(group)) % P)
    a = (az[0] + r1[0] * (az[1] - az[0])) % P
    b = (bz[0] + r1[0] * (bz[1] - bz[0])) % P
    need(final == alpha * eq % P * a % P * b % P,
         "stage-1 final claim is not eq * Az * Bz")

    # stage 2: the product-virtualization skip, then the batched sumcheck
    tau_high = tp.challenge()
    s2 = proof["skip2"]
    need(len(s2) == 3 * (PRODUCT_DOMAIN - 1) + 1, "stage-2 skip degree")
    for i, name in enumerate(PRODUCTS):
        y = i - (PRODUCT_DOMAIN - 1) // 2
        need(horner(s2, y % P) == kernel(PRODUCT_DOMAIN, y % P, tau_high)
             * w[name] % P, f"stage-2 skip polynomial at {y}")
    r0_2 = skip_challenge(tp, s2)
    claim2 = horner(s2, r0_2)
    need(claim(proof, "UnivariateSkip", PRODUCT_VIRT) == claim2,
         "stage-2 skip claim")
    tp.scalar(claim2)
    gamma_rw = tp.challenge_full()
    for _ in range(log_ram_k):
        tp.challenge()
    gamma_in = tp.challenge_full()
    inputs = [claim2, w["RamAddress"],
              (w["RamReadValue"] + gamma_rw * w["RamWriteValue"]) % P, 0,
              (w["LookupOutput"] + gamma_in * w["LeftLookupOperand"]
               + gamma_in * gamma_in % P * w["RightLookupOperand"]) % P]
    counts = [n, log_ram_k, log_ram_k + n, log_ram_k, n]
    for v in inputs:
        tp.scalar(v)
    most = log_ram_k + n
    batched = sum(v * pow(2, most - c, P) % P * tp.challenge_full()
                  for v, c in zip(inputs, counts)) % P
    need(len(proof["stages"][2]) == most, "stage-2 round count")
    _, r2 = sumcheck(tp, proof["stages"][2], batched)

    # stages 3-7: shapes; 5-7 are upstream's zero placeholders
    for stage, count in ((3, n), (4, LOG_REGISTERS + n), (5, n), (6, n),
                         (7, 4)):
        polys = proof["stages"][stage]
        need(len(polys) == count, f"stage-{stage} round count")
        need(all(len(c) == 3 for c in polys), f"stage-{stage} degree")
        if stage >= 5:
            need(not any(any(c) for c in polys),
                 f"stage {stage} is not the zero placeholder")
    return {"proof": proof, "r_cycle": r1[1:][::-1],
            "r_output": r2[most - log_ram_k:]}


# -- the claims about this execution ------------------------------------------

# (claim, the reference's per-cycle value). Upstream's compat mode reads a
# store's RamReadValue as the value it stores, not the one it overwrites.
EXECUTION_COLUMNS = {
    "UnexpandedPC": lambda c, nxt: c.pc,
    "RdWriteValue": lambda c, nxt: c.rd_write,
    "RamAddress": lambda c, nxt: c.ram_addr,
    "RamReadValue": lambda c, nxt: c.ram_write,
    "RamWriteValue": lambda c, nxt: c.ram_write,
    "NextUnexpandedPC": lambda c, nxt: nxt.pc if nxt is not None else 0,
}


def compat_ram_tables(run, log_ram_k: int) -> tuple[dict, dict]:
    """(initial, final) doublewords by index from the lowest I/O address,
    as upstream's compat output check tabulates them
    (src/zkvm/ram/output_check.zig): its emulator keeps the I/O region
    (inputs, outputs, panic, termination) apart from RAM, so the final table
    holds RAM, the panic bit and, unless the guest panicked, the termination
    word; a RAM word that ends 0 but began non-zero keeps its initial
    value; the initial table takes the I/O region but the termination word
    from the final one."""
    from .rv64 import RAM_START, io_layout

    io = io_layout()
    K = 1 << log_ram_k
    index = lambda a: (a - io["lowest"]) // 8   # noqa: E731
    in_io = lambda a: io["input"] <= a < RAM_START  # noqa: E731
    init = {index(a): v for a, v in run.initial.items()
            if not in_io(a) and 0 <= index(a) < K}
    final = {index(a): v for a, v in run.final.items()
             if not in_io(a) and 0 <= index(a) < K}
    panic_k, term_k = index(io["panic"]), index(io["termination"])
    final[panic_k] = int(run.panic)
    if not run.panic:
        final[term_k] = 1
    for k, v in init.items():
        if not final.get(k):
            final[k] = v
    for k in range(index(io["input"]), index(RAM_START)):
        if k != term_k:
            init[k] = final.get(k, 0)
    return init, final


def execution_claims(checked: dict, run, log_ram_k: int) -> list[str]:
    """The claims that differ from the reference's run of the guest: each
    execution column's multilinear extension over the padded cycles at the
    stage-1 point, and the initial and final RAM tables' at the stage-2
    output point (bound from the least significant bit)."""
    proof = checked["proof"]
    eq = eq_table(checked["r_cycle"])
    cyc = run.cycles
    bad = []
    for name, value in EXECUTION_COLUMNS.items():
        want = 0
        for t, c in enumerate(cyc):
            v = value(c, cyc[t + 1] if t + 1 < len(cyc) else None)
            if v:
                want += eq[t] * v
        if want % P != claim(proof, name, SPARTAN_OUTER):
            bad.append(f"{name}@SpartanOuter")
    point = checked["r_output"]
    init, final = compat_ram_tables(run, log_ram_k)
    for name, table in (("RamValInit", init), ("RamValFinal", final)):
        want = 0
        for k, v in table.items():
            if not v:
                continue
            e = v
            for i, r in enumerate(point):
                e = e * (r if k >> i & 1 else 1 - r) % P
            want += e
        if want % P != claim(proof, name, RAM_OUTPUT):
            bad.append(f"{name}@RamOutputCheck")
    return bad
