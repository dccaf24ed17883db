"""Bit-accurate model of the IMPULSE 10T-SRAM fused-array macro.

This is the *silicon oracle*: it models the 72 shared bitline columns, the
odd/even read-wordline interleave, the staggered V_MEM slot layout, the
bitline-logic full adders (BLFA) with their Carry-MUX modes (LSB / CF / CS /
MSB), and the conditional write drivers — at single-bit granularity. The
word-level ISA (isa.py) and the CUDA kernels are held against it through
the ``bitmacro`` backend (`pipeline.run_bitmacro`). It runs on the host in
numpy by nature: one bit at a time, never on a device.

Layout (derived from the letter's constraints; see DESIGN.md §2):

  * W_MEM rows: 128 rows x 72 columns. Weight j (of 12) occupies columns
    [6j .. 6j+5], LSB first, 6-bit two's complement; even j on RWLo (odd
    cycle), odd j on RWLe (even cycle).
  * V_MEM slots: 12 physical columns each, at columns [6j .. 6j+11] (mod 72).
    Even-j slots live in one row, odd-j slots in the staggered partner row —
    so slots never collide within a row, and in every cycle all 72 column
    peripherals are busy (full utilization, Fig. 3).
  * Guard bit: slot bit position 5 is structurally '0'. It shares its column
    with the weight's sign bit (col 6j+5), letting the carry-skip (CS) block
    read Wsign unambiguously from the bitline OR and broadcast it to the six
    upper columns — that is the sign extension of the 6-bit weight into the
    11-bit V word, and it is why V_MEM is 11 (not 12) bits.
  * V encoding: value bits v[0..4] at slot bits 0..4, v[5..10] at slot bits
    6..11; 11-bit two's complement (slot bit 11 = sign).
  * BLFA: the bitlines give OR and AND of the two enabled rows; the adder
    needs only XOR = OR & ~AND and AND — so A and B need never be read
    individually.
  * Carry-MUX modes per column: LSB (cin=0), CF (carry forward: bypass the
    guard column in V+V ops), CS (carry skip + Wsign broadcast in W+V ops),
    MSB (chain end; comparator flag out).
  * Comparator: SpikeCheck adds V + (-th) (threshold row stores the negated
    threshold) and takes the MSB peripheral's chain output; functionally this
    is the complemented sign of the 11-bit sum, i.e. v >= th whenever v-th is
    in 11-bit range (the letter's "COUT from MSB" wording).
  * Arithmetic wraps mod 2^11 (ripple adder with discarded final carry);
    saturation is a word-level policy, not silicon (isa.py clamp_mode).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.isa import MACRO_IN, MACRO_OUT, N_NEURON_SETS, InstrCount

COLS = 72
SLOT_BITS = 12
GUARD = 5                    # structural-zero slot bit position
W_BITS = 6
V_VALUE_BITS = 11


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------

def encode_w(w: int) -> np.ndarray:
    """6-bit two's complement, LSB first."""
    if not -32 <= w <= 31:
        raise ValueError(f"weight {w} exceeds the 6-bit two's-complement "
                         "range [-32, 31]")
    u = w & 0x3F
    return np.array([(u >> i) & 1 for i in range(W_BITS)], dtype=np.uint8)


def decode_w(bits: np.ndarray) -> int:
    u = int(sum(int(b) << i for i, b in enumerate(bits)))
    return u - 64 if u >= 32 else u


def encode_v(v: int) -> np.ndarray:
    """11-bit two's complement into a 12-bit slot with guard bit 5 == 0."""
    u = int(v) & 0x7FF
    bits = np.zeros(SLOT_BITS, dtype=np.uint8)
    for i in range(5):
        bits[i] = (u >> i) & 1
    for i in range(5, 11):
        bits[i + 1] = (u >> i) & 1
    return bits


def decode_v(bits: np.ndarray) -> int:
    if bits[GUARD] != 0:
        raise ValueError("guard bit violated: V slot carries a non-zero "
                         f"bit at guard position {GUARD}")
    u = sum(int(bits[i]) << i for i in range(5))
    u += sum(int(bits[i + 1]) << i for i in range(5, 11))
    return u - 2048 if u >= 1024 else u


def slot_columns(j: int) -> np.ndarray:
    """Physical columns of V slot j (staggered, wraps at 72)."""
    return (6 * j + np.arange(SLOT_BITS)) % COLS


# ---------------------------------------------------------------------------
# The bit-serial adder unit (12 columns, one slot)
# ---------------------------------------------------------------------------

def blfa_unit_add(a: np.ndarray, b: np.ndarray, guard_mode: str) -> tuple[np.ndarray, int, int]:
    """Ripple-carry add over one 12-column unit.

    a, b: (12,) slot bits. guard_mode: 'CS' (W+V: skip guard, b[>5] is the
    broadcast Wsign) or 'CF' (V+V: bypass guard). Returns (sum_bits with
    guard forced 0, msb_carry_out, sign_bit).

    Per column the bitlines sense OR(a,b) and AND(a,b); the BLFA forms
    XOR = OR & ~AND, SUM = XOR ^ cin, COUT = AND | (XOR & cin).
    """
    s = np.zeros(SLOT_BITS, dtype=np.uint8)
    cin = 0                                     # LSB mode
    for i in range(SLOT_BITS):
        if i == GUARD:
            # CS/CF: the Carry-MUX bypasses this peripheral's adder entirely
            s[i] = 0
            continue
        o, an = int(a[i] | b[i]), int(a[i] & b[i])
        x = o & (1 - an)                        # XOR from OR/AND only
        s[i] = x ^ cin
        cin = an | (x & cin)
    sign = int(s[SLOT_BITS - 1])
    return s, cin, sign                         # cin now = MSB carry-out


# ---------------------------------------------------------------------------
# Macro state (bit level)
# ---------------------------------------------------------------------------

@dataclass
class BitMacro:
    wbits: np.ndarray                           # (128, 72) uint8
    vbits: np.ndarray                           # (N_SETS, 2, 6, 12): set, parity row, slot-in-row, bit
    const: dict                                 # name -> (2, 6, 12) parity rows (threshold/reset/leak)
    spike_buf: np.ndarray                       # (N_SETS, 12) bool
    counts: InstrCount = field(default_factory=InstrCount)

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_weights(wq: np.ndarray, threshold: int, reset: int = 0, leak: int = 0) -> "BitMacro":
        if wq.shape != (MACRO_IN, MACRO_OUT):
            raise ValueError(f"macro weight tile must be "
                             f"{(MACRO_IN, MACRO_OUT)}, got {wq.shape}")
        wbits = np.zeros((MACRO_IN, COLS), dtype=np.uint8)
        for r in range(MACRO_IN):
            for j in range(MACRO_OUT):
                wbits[r, 6 * j:6 * j + 6] = encode_w(int(wq[r, j]))
        vbits = np.zeros((N_NEURON_SETS, 2, 6, SLOT_BITS), dtype=np.uint8)
        for s in range(N_NEURON_SETS):
            for j in range(MACRO_OUT):
                vbits[s, j % 2, j // 2] = encode_v(0)
        const = {}
        for name, val in (("threshold_neg", -threshold), ("reset", reset), ("leak_neg", -leak)):
            rows = np.zeros((2, 6, SLOT_BITS), dtype=np.uint8)
            for j in range(MACRO_OUT):
                rows[j % 2, j // 2] = encode_v(val)
            const[name] = rows
        return BitMacro(wbits=wbits, vbits=vbits, const=const,
                        spike_buf=np.zeros((N_NEURON_SETS, MACRO_OUT), dtype=bool))

    # -- helpers -------------------------------------------------------------
    def _slot(self, set_idx: int, j: int) -> np.ndarray:
        return self.vbits[set_idx, j % 2, j // 2]

    def read_v(self, set_idx: int) -> np.ndarray:
        return np.array([decode_v(self._slot(set_idx, j)) for j in range(MACRO_OUT)])

    # -- instructions (one call = one cycle = one parity) --------------------
    def acc_w2v(self, set_idx: int, in_row: int, cycle: int) -> None:
        """Triple-row decode: W RWLo/e + V RWL + V WWL. Adds the 6 parity
        weights of `in_row` into the 6 same-parity V slots simultaneously."""
        for j in range(cycle, MACRO_OUT, 2):
            wslice = self.wbits[in_row, 6 * j:6 * j + 6]
            wsign = int(wslice[W_BITS - 1])
            b = np.zeros(SLOT_BITS, dtype=np.uint8)
            b[:5] = wslice[:5]
            b[GUARD] = wsign                     # shares the guard column; readable because guard==0
            b[GUARD + 1:] = wsign                # CS broadcast = sign extension
            a = self._slot(set_idx, j)
            s, _, _ = blfa_unit_add(a, b, guard_mode="CS")
            self.vbits[set_idx, j % 2, j // 2] = s
        self.counts += InstrCount(acc_w2v=1)

    def _vv_operand(self, name_or_set, set_idx: int, j: int) -> np.ndarray:
        if isinstance(name_or_set, str):
            return self.const[name_or_set][j % 2, j // 2]
        if isinstance(name_or_set, np.ndarray):   # another macro's V rows
            return name_or_set[j % 2, j // 2]
        return self.vbits[name_or_set, j % 2, j // 2]

    def acc_v2v(self, set_idx: int, src, cycle: int, conditional: bool = False) -> None:
        """V[set, parity] += src[parity]. ``src`` is a const-row name, a
        local set index, or a (2, 6, 12) bit array exported by another
        macro's `transfer_v` — the word-level AccV2V partial-sum reduction
        of the distributed multi-macro architecture (mapping.py)."""
        for j in range(cycle, MACRO_OUT, 2):
            if conditional and not self.spike_buf[set_idx, j]:
                continue                         # CWD leaves bitlines precharged
            a = self._slot(set_idx, j)
            b = self._vv_operand(src, set_idx, j)
            s, _, _ = blfa_unit_add(a, b, guard_mode="CF")
            self.vbits[set_idx, j % 2, j // 2] = s
        self.counts += InstrCount(acc_v2v=1)

    def transfer_v(self, set_idx: int) -> np.ndarray:
        """Export one neuron set's V rows for a cross-macro AccV2V and clear
        them to zero — the fan-in-split macro handing its partial sum to the
        reduction target. The executed cycles are counted on the *receiving*
        macro's `acc_v2v` (one macro-to-macro AccV2V instruction drives both
        arrays in the same cycle: this macro reads its bitlines while the
        target's BLFA adds; the CWD rewrites the reset pattern on the way
        out), matching the analytic reduction term of
        `isa.count_layer_instructions_from_events` exactly."""
        bits = self.vbits[set_idx].copy()
        self.vbits[set_idx] = 0                    # encode_v(0) is all-zero
        return bits

    def spike_check(self, set_idx: int, cycle: int) -> None:
        """Adder-as-comparator against the (negated) threshold row; latches
        the spike buffers. Read-only on V."""
        for j in range(cycle, MACRO_OUT, 2):
            a = self._slot(set_idx, j)
            b = self.const["threshold_neg"][j % 2, j // 2]
            _, _, sign = blfa_unit_add(a, b, guard_mode="CF")
            self.spike_buf[set_idx, j] = (sign == 0)   # v - th >= 0
        self.counts += InstrCount(spike_check=1)

    def reset_v(self, set_idx: int, cycle: int) -> None:
        """BLFA bypassed: SINV -> CWD direct; write gated by spike buffers."""
        for j in range(cycle, MACRO_OUT, 2):
            if self.spike_buf[set_idx, j]:
                self.vbits[set_idx, j % 2, j // 2] = self.const["reset"][j % 2, j // 2].copy()
        self.counts += InstrCount(reset_v=1)

    # -- neuron-update sequences (Fig. 6) ------------------------------------
    def neuron_update(self, set_idx: int, neuron: str) -> np.ndarray:
        if neuron == "lif":
            for c in (0, 1):
                self.acc_v2v(set_idx, "leak_neg", c)
        for c in (0, 1):
            self.spike_check(set_idx, c)
        if neuron == "rmp":
            for c in (0, 1):
                self.acc_v2v(set_idx, "threshold_neg", c, conditional=True)
        elif neuron in ("if", "lif"):
            for c in (0, 1):
                self.reset_v(set_idx, c)
        else:
            raise ValueError(neuron)
        return self.spike_buf[set_idx].copy()

    def timestep(self, set_idx: int, in_spikes: np.ndarray, neuron: str) -> np.ndarray:
        rows = np.nonzero(np.asarray(in_spikes).astype(bool))[0]
        for r in rows:
            self.acc_w2v(set_idx, int(r), cycle=0)
            self.acc_w2v(set_idx, int(r), cycle=1)
        return self.neuron_update(set_idx, neuron)


def physical_layout_check() -> bool:
    """Verify the staggered slot layout: within each parity row slots are
    column-disjoint and jointly cover all 72 columns; across W/V the weight
    columns are the low half of their slot."""
    for parity in (0, 1):
        cols: list[int] = []
        for j in range(parity, MACRO_OUT, 2):
            cols.extend(slot_columns(j).tolist())
        if sorted(cols) != list(range(COLS)):
            raise RuntimeError(
                f"staggered layout broken: parity-{parity} slots do not "
                f"tile the {COLS} columns ({sorted(cols)})")
    for j in range(MACRO_OUT):
        if list(slot_columns(j)[:6]) != list(range(6 * j, 6 * j + 6)):
            raise RuntimeError(
                f"slot {j}: weight columns are not the low half of the "
                "slot")
    return True
