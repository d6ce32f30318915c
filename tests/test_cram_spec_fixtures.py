"""Writer-independent CRAM spec fixtures (the test_index_spec_fixtures.py
discipline applied to the CRAM layer).

Round-trip tests can never catch a bug that encoder and decoder share (the
round-2 rANS order-1 floor(n/4) split bug was exactly that class), so this
file decodes byte streams this repo's writer never produced:

* rANS 4x8 order-0/order-1 payloads assembled by hand from hts-specs
  CRAMcodecs section 3 (worked state arithmetic in comments), including
  n % 4 != 0 sizes that exercise the tail-on-state-3 layout;
* a complete CRAM 3.0 container assembled field-by-field whose data series
  use encoding codecs the writer never emits: BETA core bits, canonical
  multi-symbol HUFFMAN, and BYTE_ARRAY_LEN with a BETA length.
"""

import struct

import pytest

from portello_tpu.io import cram
from portello_tpu.io.cram import (
    CRAM_EOF,
    CRAM_MAGIC,
    E_BETA,
    E_BYTE_ARRAY_LEN,
    E_EXTERNAL,
    E_HUFFMAN,
    Encoding,
    encode_encoding,
    write_block,
    write_container_header,
    write_itf8,
    write_ltf8,
)


# ---------------------------------------------------------------------------
# rANS 4x8 hand-assembled payloads (spec: [order u8][clen u32][rlen u32]...)
# ---------------------------------------------------------------------------

def _rans4x8(order: int, payload: bytes, n_out: int) -> bytes:
    return struct.pack("<BII", order, len(payload), n_out) + payload


class TestRans4x8SpecStreams:
    def test_order0_single_symbol(self):
        """'G' x 5 with F[G] = 4096: the decode step r = 4096*(r>>12) +
        (r & 4095) is the identity, so all four states hold their 2^23
        initial and there is no byte payload."""
        payload = (
            b"\x47"              # first symbol 'G'
            b"\x90\x00"          # F = 4096 (two-byte >=128 form)
            b"\x00"              # next-symbol terminator
            + b"\x00\x00\x80\x00" * 4  # states: 8388608 LE x4
        )
        assert cram.rans_decode(_rans4x8(0, payload, 5)) == b"GGGGG"

    def test_order0_two_symbols_worked_states(self):
        """"ab", F[a]=F[b]=2048, states computed by hand:
        'b' via state1: R = (2^23/2048)<<12 + 0 + C[b]=2048 -> 16779264;
        'a' via state0: R = 4096<<12 -> 16777216.  No renormalisation."""
        payload = (
            b"\x61"              # first symbol 'a'
            b"\x88\x00"          # F[a] = 2048
            b"\x62"              # next symbol 'b' (= a+1)
            b"\x00"              # run byte 0
            b"\x88\x00"          # F[b] = 2048
            b"\x00"              # terminator
            b"\x00\x00\x00\x01"  # state0 = 16777216
            b"\x00\x08\x00\x01"  # state1 = 16779264
            b"\x00\x00\x80\x00"  # state2 = 8388608
            b"\x00\x00\x80\x00"  # state3 = 8388608
        )
        assert cram.rans_decode(_rans4x8(0, payload, 2)) == b"ab"

    def test_order1_tail_on_state3_n5(self):
        """'a' x 5 (n % 4 = 1): quarters of floor(5/4)=1 at 0/1/2/3 and the
        tail [4,5) on state 3 continuing its context chain.  Contexts 0 and
        'a' both map 'a'->4096, so every state is the 2^23 identity."""
        row = b"\x61\x90\x00\x00"  # {a: 4096}
        payload = (
            b"\x00" + row          # context 0
            + b"\x61" + row        # context 'a'
            + b"\x00"              # context terminator
            + b"\x00\x00\x80\x00" * 4
        )
        assert cram.rans_decode(_rans4x8(1, payload, 5)) == b"aaaaa"

    def test_order1_two_contexts_worked_states(self):
        """"ababa" (n=5): F[0]={a:2048,b:2048}, F['b']={a:4096}.
        Worked encode (reverse order, LIFO):
          (s3,i4)'a'|ctx'b': identity  -> R3 = 2^23
          (s3,i3)'b'|ctx0: (2^23/2048)<<12 + C[b]=2048 -> 16779264
          (s2,i2)'a'|ctx0 -> 16777216;  (s1,i1)'b' -> 16779264;
          (s0,i0)'a' -> 16777216.  No renormalisation bytes."""
        row0 = b"\x61\x88\x00\x62\x00\x88\x00\x00"  # {a:2048, b:2048}
        rowb = b"\x61\x90\x00\x00"                  # {a:4096}
        payload = (
            b"\x00" + row0
            + b"\x62" + rowb
            + b"\x00"
            + b"\x00\x00\x00\x01"  # R0 = 16777216
            + b"\x00\x08\x00\x01"  # R1 = 16779264
            + b"\x00\x00\x00\x01"  # R2 = 16777216
            + b"\x00\x08\x00\x01"  # R3 = 16779264
        )
        assert cram.rans_decode(_rans4x8(1, payload, 5)) == b"ababa"

    def test_order0_truncated_freq_table_raises(self):
        with pytest.raises(Exception):
            cram.rans_decode(_rans4x8(0, b"\x47\x90", 5))


# ---------------------------------------------------------------------------
# hand-assembled container (encodings the writer never emits)
# ---------------------------------------------------------------------------

def _huff(alphabet, bit_lens):
    e = Encoding(E_HUFFMAN)
    e.alphabet = list(alphabet)
    e.bit_lens = list(bit_lens)
    return e


def _beta(offset, n_bits):
    e = Encoding(E_BETA)
    e.offset = offset
    e.n_bits = n_bits
    return e


def _ext(cid):
    e = Encoding(E_EXTERNAL)
    e.content_id = cid
    return e


def _byte_array_len(len_enc, val_enc):
    e = Encoding(E_BYTE_ARRAY_LEN)
    e.len_enc = len_enc
    e.val_enc = val_enc
    return e


def _build_hand_container(tmp_path):
    """One detached unmapped record ('uX', seq ACGT, quals 30..33) coded
    with BETA core bits (BF, AP), a 2-symbol canonical HUFFMAN (CF), and
    BYTE_ARRAY_LEN{BETA len, EXTERNAL val} (RN)."""
    series = [
        (b"BF", _beta(0, 8)),             # core: 8 bits, value 4 (FUNMAP)
        (b"CF", _huff([2, 3], [1, 1])),   # core: 1 bit, value 3 (code 1)
        (b"RL", _ext(1)),                 # external itf8
        (b"AP", _beta(0, 3)),             # core: 3 bits, value 0
        (b"RG", _huff([-1], [0])),        # zero-bit constant
        (b"RN", _byte_array_len(_beta(0, 4), _ext(2))),
        (b"MF", _huff([0], [0])),
        (b"NS", _huff([-1], [0])),
        (b"NP", _huff([0], [0])),
        (b"TS", _huff([0], [0])),
        (b"TL", _huff([0], [0])),
        (b"BA", _ext(3)),
        (b"QS", _ext(4)),
    ]
    series_blob = write_itf8(len(series)) + b"".join(
        key + encode_encoding(e) for key, e in series
    )
    pres = (
        write_itf8(3)
        + b"RN\x01" + b"AP\x00"
        + b"TD" + write_itf8(1) + b"\x00"   # one empty tag line (TL=0)
    )
    chdr = (
        write_itf8(len(pres)) + pres
        + write_itf8(len(series_blob)) + series_blob
        + write_itf8(1) + write_itf8(0)     # zero tag encodings (size, n)
    )
    # core bits per record: BF 00000100 | CF 1 | AP 000 | RN-len 0010
    core = bytes([0b00000100, 0b10000010])
    ext_streams = {
        1: write_itf8(4),        # RL = 4
        2: b"uX",                # RN value bytes
        3: b"ACGT",              # BA
        4: bytes([30, 31, 32, 33]),  # QS
    }
    chdr_blk = write_block(cram.RAW, cram.COMPRESSION_HEADER, 0, chdr)
    blocks = [write_block(cram.RAW, cram.CORE_T, 0, core)]
    for cid, data in sorted(ext_streams.items()):
        blocks.append(write_block(cram.RAW, cram.EXTERNAL_T, cid, data))
    sh = bytearray()
    sh += write_itf8(-1)          # ref id: unmapped slice
    sh += write_itf8(0)           # start
    sh += write_itf8(0)           # span
    sh += write_itf8(1)           # n_records
    sh += write_ltf8(0)           # record counter
    sh += write_itf8(len(blocks))
    sh += write_itf8(len(ext_streams))
    for cid in sorted(ext_streams):
        sh += write_itf8(cid)
    sh += write_itf8(-1)          # no embedded reference
    sh += b"\x00" * 16            # MD5 (unchecked)
    sh_blk = write_block(cram.RAW, cram.SLICE_HEADER, 0, bytes(sh))
    body = chdr_blk + sh_blk + b"".join(blocks)
    h = cram.ContainerHeader(
        len(body), -1, 0, 0, 1, 0, 4, 2 + len(blocks), [len(chdr_blk)]
    )

    text = b"@HD\tVN:1.6\n"
    hdr_payload = struct.pack("<i", len(text)) + text
    hdr_blk = write_block(cram.RAW, cram.FILE_HEADER, 0, hdr_payload)
    hdr_cont = cram.ContainerHeader(len(hdr_blk), 0, 0, 0, 0, 0, 0, 1, [0])

    path = tmp_path / "hand.cram"
    with open(path, "wb") as f:
        f.write(CRAM_MAGIC + bytes([3, 0]) + b"spec-fixture".ljust(20, b"\x00"))
        f.write(write_container_header(hdr_cont))
        f.write(hdr_blk)
        f.write(write_container_header(h))
        f.write(body)
        f.write(CRAM_EOF)
    return str(path)


def test_hand_container_beta_huffman_byte_array_len(tmp_path):
    path = _build_hand_container(tmp_path)
    with cram.CramReader(path) as r:
        recs = list(r)
    assert len(recs) == 1
    rec = recs[0]
    assert rec.qname == b"uX"
    assert rec.flag == 4
    assert rec.tid == -1
    assert rec.pos == -1
    assert rec.mapq == 0
    assert rec.seq.tobytes() == b"ACGT"
    assert rec.qual.tolist() == [30, 31, 32, 33]
    assert rec.mtid == -1 and rec.tlen == 0
    assert rec.tags == []


# ---------------------------------------------------------------------------
# Writer-independent serialisation
# fixtures for the three codecs whose framing was previously certified only
# by this repo's own encoders — arith (method 6), fqzcomp (method 7), tok3
# (method 8).  The byte streams below were derived with an INDEPENDENT
# transcription of the published htscodecs algorithms (reproduced in
# _RefRC/_RefModel so the derivation is auditable in-tree), hard-coded, and
# are decoded here by the production decoders.  Several exercise modes this
# repo's encoders never emit (forced order-0 on tiny input, multi-parameter
# fqzcomp with a selector table, tok3 duplicate-stream descriptors).
# ---------------------------------------------------------------------------


class _RefRC:
    """Independent transcription of the htscodecs carry-propagating range
    coder (LZMA style: 32-bit range, renorm below 2^24, 5-byte flush) used
    to DERIVE the fixtures below — not the implementation under test."""

    def __init__(self):
        self.low, self.rng = 0, 0xFFFFFFFF
        self.cache, self.cache_size = 0, 1
        self.out = bytearray()

    def _shift(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            self.out.extend([(0xFF + carry) & 0xFF] * (self.cache_size - 1))
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def enc(self, cum, freq, tot):
        r = self.rng // tot
        self.low += cum * r
        self.rng = r * freq
        while self.rng < (1 << 24):
            self.rng = (self.rng << 8) & 0xFFFFFFFF
            self._shift()

    def finish(self):
        for _ in range(5):
            self._shift()
        return bytes(self.out)


class _RefModel:
    """Adaptive model per the spec: init 1/symbol, +16 on use, halve
    (rounding up) when the total passes 2^15."""

    def __init__(self, nsym=256):
        self.f, self.tot = [1] * nsym, nsym

    def enc(self, rc, s):
        rc.enc(sum(self.f[:s]), self.f[s], self.tot)
        self.f[s] += 16
        self.tot += 16
        if self.tot > (1 << 15):
            self.tot = 0
            for i in range(len(self.f)):
                self.f[i] = (self.f[i] + 1) >> 1
                self.tot += self.f[i]


class TestArithSpecStreams:
    def test_cat_and_nosz_framing(self):
        from portello_tpu.io import arith_nx16

        # flags CAT(0x20), uint7 len, raw payload
        assert arith_nx16.decode(b"\x20\x03abc") == b"abc"
        # flags CAT|NOSZ(0x30): no length field, external length
        assert arith_nx16.decode(b"\x30abcd", n_out=4) == b"abcd"

    def test_pack_cat_framing(self):
        from portello_tpu.io import arith_nx16

        # PACK|CAT: 4-symbol map ACGT, 6 values, 2 bits each little-endian
        # within the byte: ACGTAC -> 0|1<<2|2<<4|3<<6 = 0xE4, 0|1<<2 = 0x04
        stream = b"\xa0\x06\x04ACGT\x02\xe4\x04"
        assert arith_nx16.decode(stream) == b"ACGTAC"

    def test_order0_worked_states(self):
        """'AB' order-0, derived by hand + _RefRC:

        encode 'A'(65): r = 0xFFFFFFFF//256 = 0xFFFFFF; low = 65*0xFFFFFF
        = 0x40FFFFBF; range = 0xFFFFFF < 2^24 -> one renorm emitting the
        initial zero cache, cache=0x40, low=0xFFFFBF00; model A: F[65]=17,
        total=272.  encode 'B'(66): r = 0xFFFFFF00//272 = 15790320,
        cum = 65+17 = 82; low overflows 32 bits -> the carry bumps the
        cached 0x40 to 0x41 during the flush.  Payload:
        00 41 4D 2C EB E0 00."""
        from portello_tpu.io import arith_nx16

        raw = b"AB"
        fixture = bytes.fromhex("000200414d2cebe000")
        rc = _RefRC()
        m = _RefModel()
        for b in raw:
            m.enc(rc, b)
        assert bytes([0x00, len(raw)]) + rc.finish() == fixture
        assert arith_nx16.decode(fixture) == raw

    def test_order0_longer_stream(self):
        from portello_tpu.io import arith_nx16

        raw = b"hello hello"
        fixture = bytes.fromhex("000b00685f842fa92753b8087d2200")
        rc = _RefRC()
        m = _RefModel()
        for b in raw:
            m.enc(rc, b)
        assert bytes([0x00, len(raw)]) + rc.finish() == fixture
        assert arith_nx16.decode(fixture) == raw
        # this repo's encoder happens to agree byte-for-byte here — pins
        # the serialisation in both directions
        assert arith_nx16.encode(raw, order=0) == fixture

    def test_order1_worked_states(self):
        """Order-1: one adaptive model per previous byte (initial context
        0).  'abcabc': model[0] codes 'a', model[a] codes 'b' twice, etc."""
        from portello_tpu.io import arith_nx16

        for raw, hexstream in (
            (b"abcabc", "010600616262ffffabadad00"),
            (b"mississippi", "010b006d697305f9cc6ada4399104600"),
        ):
            fixture = bytes.fromhex(hexstream)
            rc = _RefRC()
            models = {}
            last = 0
            for b in raw:
                m = models.get(last)
                if m is None:
                    m = models[last] = _RefModel()
                m.enc(rc, b)
                last = b
            assert bytes([0x01, len(raw)]) + rc.finish() == fixture
            assert arith_nx16.decode(fixture) == raw
            assert arith_nx16.encode(raw, order=1) == fixture


class TestFqzcompSpecStreams:
    def test_multi_param_selector_dedup_rev(self):
        """A stream this repo's fqzcomp encoder can NEVER produce: two
        parameter sets + GFLAG_HAVE_STAB selector table + DO_REV + dedup.

        Header, field by field:
          05                      version 5
          07                      gflags MULTI_PARAM|HAVE_STAB|DO_REV
          02                      nparam = 2
          01                      max_sel = 1
          01 FF 00                stab double-RLE: value0 x1, value1 x255
                                  (run 255 + continuation 0) = 256 entries
          00 00 0C 40 42 0C 00    param0: ctx 0x0000, pflags DO_LEN|DO_SEL,
                                  max_sym 64, qbits4/qshift2, qloc0/sloc12
          00 10 1E 02 42 0C 00    param1: ctx 0x1000, pflags DO_LEN|DO_SEL|
                                  DO_DEDUP|HAVE_QMAP, max_sym 2
          21 2A                   qmap {33, 42}
        then the range-coded payload: per record sel, 4-byte length models,
        rev bit, (param1) dup bit, then per-quality adaptive models over
        ctx = base + (qctx & 15) + (sel << 12).  Three records: param0
        [5,6,5] forward; param1 [33,42,33] stored-reversed (decoder
        re-reverses at the end); param1 dedup of the previous record."""
        from portello_tpu.io import fqzcomp

        stream = bytes.fromhex(
            "0507020101ff0000000c40420c0000101e02420c00212a"
            "00017ffffd0503edef81663755dccd54ef6100"
        )
        recs = [bytes([5, 6, 5]), bytes([33, 42, 33]), bytes([33, 42, 33])]
        # rec1 and its dedup copy are flagged reversed
        expected = recs[0] + recs[1][::-1] + recs[2][::-1]

        # derivation (auditable): encode with the independent coder in the
        # documented decode order
        rc = _RefRC()
        m_sel, m_rev, m_dup = _RefModel(2), _RefModel(2), _RefModel(2)
        m_len = [_RefModel(256) for _ in range(4)]
        m_q = {}
        prev = None
        for sel, rec, is_rev in (
            (0, recs[0], False), (1, recs[1], True), (1, recs[2], False),
        ):
            m_sel.enc(rc, sel)
            base, qmap = (0x0000, None) if sel == 0 else (0x1000, [33, 42])
            ln = len(rec)
            for bi in range(4):
                m_len[bi].enc(rc, (ln >> (8 * bi)) & 0xFF)
            m_rev.enc(rc, 1 if is_rev else 0)
            if sel == 1:
                isdup = prev == rec
                m_dup.enc(rc, 1 if isdup else 0)
                if isdup:
                    continue
            qctx = 0
            for b in rec:
                q = qmap.index(b) if qmap is not None else b
                ctx = (base + (qctx & 15) + (sel << 12)) & 0xFFFF
                m = m_q.get(ctx)
                if m is None:
                    m = m_q[ctx] = _RefModel(65)  # max(max_sym)+1
                m.enc(rc, q)
                qctx = (qctx << 2) + q
            prev = rec
        header = bytes.fromhex(
            "0507020101ff0000000c40420c0000101e02420c00212a"
        )
        assert header + rc.finish() == stream
        assert fqzcomp.decode(stream, n_out=len(expected)) == expected


class TestTok3SpecStreams:
    # hand-built stream for names "a1b2" x2: per-position streams carried
    # as CAT-framed payloads (0x20 flags + uint7 length — the degenerate
    # entropy stream both rANS Nx16 and arith accept), with positions 3 and
    # 4's TYPE streams expressed as DUPLICATE descriptors (bit6) pointing
    # back at positions 1 and 2 — a descriptor form this repo's encoder
    # only emits when payloads collide, here forced deliberately.
    #
    #   0A000000 02000000 <flags>      ulen 10, nnames 2, coder flag
    #   80 04 20020606                 pos0 TYPE:   [DIFF, DIFF]
    #   06 0A 2008 00000000 00000000   pos0 DIFF:   u32 0, u32 0
    #   80 04 2002010A                 pos1 TYPE:   [STRING, MATCH]
    #   01 04 20026100                 pos1 STRING: "a\0"
    #   80 04 2002070A                 pos2 TYPE:   [DIGITS, MATCH]
    #   07 06 200401000000             pos2 DIGITS: u32 1
    #   C0 01 00                       pos3 TYPE:   dup of (pos1, TYPE)
    #   01 04 20026200                 pos3 STRING: "b\0"
    #   C0 02 00                       pos4 TYPE:   dup of (pos2, TYPE)
    #   07 06 200402000000             pos4 DIGITS: u32 2
    #   80 04 20020C0C                 pos5 TYPE:   [END, END]
    _BODY = (
        "800420020606"
        "060a2008000000000000000080042002010a01042002610080042002070a"
        "0706200401000000c00100010420026200c002000706200402000000"
        "800420020c0c"
    )

    def test_rans_variant_with_dup_streams(self):
        from portello_tpu.io import tok3

        stream = bytes.fromhex("0a00000002000000" + "00" + self._BODY)
        assert tok3.decode(stream) == b"a1b2\x00a1b2\x00"

    def test_arith_flag_variant(self):
        """flags bit0 routes every stream payload through the arith codec;
        the CAT framing byte (0x20 + uint7 len) is shared, so the same
        payload bytes exercise the arith dispatch path."""
        from portello_tpu.io import tok3

        stream = bytes.fromhex("0a00000002000000" + "01" + self._BODY)
        assert tok3.decode(stream) == b"a1b2\x00a1b2\x00"


# ---------------------------------------------------------------------------
# ENCODER-golden fixtures: the sections above pin what the
# DECODERS accept; these pin the exact bytes this repo's encoders EMIT.
# Expected streams are assembled from hand-written framing (headers,
# descriptors, CAT frames, uint7 lengths — every byte annotated) plus
# independent transcriptions of the published entropy stages (_RefRansO0
# below for rANS Nx16 order-0; the _RefRC/_RefModel range coder above for
# the arith variant), with the two simplest rANS bodies additionally pinned
# to fully hand-derived literals.  A divergence in any serialisation choice
# the encoders make now fails byte-for-byte instead of hiding behind
# round-trips (the round-2 rANS-O1 failure mode, write side).
# ---------------------------------------------------------------------------


def _ref_uint7(v: int) -> bytes:
    parts = [v & 0x7F]
    v >>= 7
    while v:
        parts.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(parts))


class _RefRansO0:
    """Independent transcription of the htscodecs rANS Nx16 order-0 encoder:
    NormaliseFrequencies to 2^12 (floor 1 for present symbols, residue onto
    the largest), the ascending "+1-run" alphabet serialisation, uint7
    frequencies, and 4 interleaved states encoding backward with a single
    16-bit renormalisation against x_max = ((2^15 >> 12) << 16) * freq.
    Used to DERIVE fixtures — not the implementation under test."""

    @staticmethod
    def _alpha(A: list[int]) -> bytes:
        out = bytearray([A[0]])
        i = 0
        while i < len(A):
            nxt = A[i + 1] if i + 1 < len(A) else 0
            out.append(nxt)
            if nxt == A[i] + 1:
                run = 0
                while i + 2 + run < len(A) and A[i + 2 + run] == nxt + 1 + run:
                    run += 1
                out.append(run)
                i += 1 + run
            else:
                i += 1
        return bytes(out)

    @classmethod
    def encode(cls, raw: bytes) -> bytes:
        counts = [0] * 256
        for b in raw:
            counts[b] += 1
        F = [(c * 4096) // len(raw) for c in counts]
        for s in range(256):
            if counts[s] and F[s] == 0:
                F[s] = 1
        F[F.index(max(F))] += 4096 - sum(F)
        C = [0] * 257
        for s in range(256):
            C[s + 1] = C[s] + F[s]
        A = [s for s in range(256) if F[s]]
        tab = bytearray(cls._alpha(A))
        for s in A:
            tab += _ref_uint7(F[s])
        R = [0x8000] * 4
        rev = bytearray()
        for i in range(len(raw) - 1, -1, -1):
            s = raw[i]
            f = F[s]
            r = R[i % 4]
            if r >= ((0x8000 >> 12) << 16) * f:
                rev += bytes([(r >> 8) & 0xFF, r & 0xFF])
                r >>= 16
            R[i % 4] = ((r // f) << 12) + (r % f) + C[s]
        body = b"".join(struct.pack("<I", R[j]) for j in range(4))
        return (
            b"\x00" + _ref_uint7(len(raw)) + bytes(tab) + body
            + bytes(reversed(rev))
        )


def _ref_arith_o0(raw: bytes) -> bytes:
    """arith Nx16 order-0 frame via the independent range-coder/model
    transcription above: flags 0x00, uint7 raw length, RC payload."""
    rc = _RefRC()
    m = _RefModel()
    for b in raw:
        m.enc(rc, b)
    return b"\x00" + _ref_uint7(len(raw)) + rc.finish()


class TestEncoderGoldenOutputs:
    # two names, 21 bytes each incl. the NUL separator (ulen 42 = 0x2A):
    # tokens STRING "abcdefghi" / CHAR "." / STRING "abcdefghi" / DIGITS n.
    # Name 2 MATCHes positions 1-3 and DELTAs the digits, so the encode
    # exercises DIFF, MATCH, DELTA, CAT framing, order-0 bodies, and the
    # bit-6 duplicate-stream descriptor (the 10-byte STRING stream repeats
    # at position 3).
    _NAMES = b"abcdefghi.abcdefghi1\x00abcdefghi.abcdefghi2\x00"

    @staticmethod
    def _frag(desc: int, comp: bytes) -> bytes:
        return bytes([desc]) + _ref_uint7(len(comp)) + comp

    def test_ref_rans_o0_hand_derived_bodies(self):
        """The two simple order-0 bodies, fully derived by hand.

        8 zero bytes: alphabet {0} -> 00 00; freq 4096 -> uint7 A0 00.
        Encoding symbol 0 (freq 4096 = the whole 2^12 table, cum 0) maps
        state 0x8000 to ((0x8000//4096)<<12) + (0x8000%4096) + 0 = 0x8000:
        all four states stay at the 2^15 lower bound and no renormalisation
        bytes are emitted -> four LE words 00 80 00 00.

        01 00 00 00: counts {0:3, 1:1} normalise to F0=3072 (uint7 98 00),
        F1=1024 (88 00); alphabet {0,1} -> 00 01 00 00.  States 1-3 encode
        symbol 0: (0x8000//3072)<<12 + (0x8000%3072) = (10<<12)+2048 =
        0xA800.  State 0 encodes symbol 1 (cum 3072): (0x8000//1024)<<12
        + 0 + 3072 = 0x20C00."""
        assert _RefRansO0.encode(b"\x00" * 8) == bytes.fromhex(
            "0008" + "0000a000" + "00800000" * 4
        )
        assert _RefRansO0.encode(b"\x01\x00\x00\x00") == bytes.fromhex(
            "0004" + "00010000" + "9800" + "8800"
            + "000c0200" + "00a80000" * 3
        )

    def _expected(self, o0, flags: int) -> bytes:
        f = self._frag
        return (
            struct.pack("<II", 42, 2) + bytes([flags])
            + f(0x80, b"\x20\x02\x06\x06")          # pos0 TYPE [DIFF,DIFF]
            + f(0x06, o0(b"\x00" * 8))              # pos0 DIFF u32 0, u32 0
            + f(0x80, b"\x20\x02\x01\x0a")          # pos1 TYPE [STRING,MATCH]
            + f(0x01, o0(b"abcdefghi\x00"))         # pos1 STRING
            + f(0x80, b"\x20\x02\x02\x0a")          # pos2 TYPE [CHAR,MATCH]
            + f(0x02, b"\x20\x01\x2e")              # pos2 CHAR "."
            + f(0x80, b"\x20\x02\x01\x0a")          # pos3 TYPE [STRING,MATCH]
            + bytes([0x41, 1, 1])                   # pos3 STRING = dup(1,1)
            + f(0x80, b"\x20\x02\x07\x08")          # pos4 TYPE [DIGITS,DELTA]
            + f(0x07, o0(b"\x01\x00\x00\x00"))      # pos4 DIGITS u32 1
            + f(0x08, b"\x20\x01\x01")              # pos4 DELTA +1
            + f(0x80, b"\x20\x02\x0c\x0c")          # pos5 TYPE [END,END]
        )

    def test_tok3_encoder_bytes_rans(self):
        from portello_tpu.io import tok3

        got = tok3.encode(self._NAMES)
        assert got == self._expected(_RefRansO0.encode, 0)
        assert tok3.decode(got) == self._NAMES

    def test_tok3_encoder_bytes_arith(self):
        from portello_tpu.io import tok3

        got = tok3.encode(self._NAMES, use_arith=True)
        assert got == self._expected(_ref_arith_o0, 1)
        assert tok3.decode(got) == self._NAMES

    def test_arith_encoder_bytes(self):
        """Production arith encode, order 0: flags 00, uint7 4, then the
        carry-propagating range coder payload (independent transcription)."""
        from portello_tpu.io import arith_nx16

        raw = b"ABAB"
        assert arith_nx16.encode(raw, order=0) == _ref_arith_o0(raw)
        # sub-4-byte payloads must CAT (flags 0x20, uint7 len, raw)
        assert arith_nx16.encode(b"AB", order=0) == b"\x20\x02AB"

    def test_rans_encoder_bytes(self):
        """Production rANS Nx16 encode, order 0, pinned to the independent
        transcription (and transitively to the hand-derived literals)."""
        from portello_tpu.io import rans_nx16

        for raw in (b"\x00" * 8, b"\x01\x00\x00\x00", b"abcdefghi\x00",
                    b"qualityquality!!"):
            assert rans_nx16.encode(raw, order=0) == _RefRansO0.encode(raw)
        assert rans_nx16.encode(b"ab", order=0) == b"\x20\x02ab"

    def test_fqzcomp_encoder_header_bytes(self):
        """fqzcomp header the writer emits for a single-symbol quality run:
        vers 5, gflags 0; param block: context 0000, pflags 0x34
        (DO_LEN|HAVE_QMAP|HAVE_PTAB), max_sym 1, qbits/qshift A5 (10,5),
        qloc/sloc 0F (0,15), ploc/dloc AF (10,15), qmap [0x23 '#'], ptab
        (64 runs of 16) RLE'd to 10 10 3F (run 16, equal-run marker 16,
        63 further copies)."""
        from portello_tpu.io import fqzcomp

        enc = fqzcomp.encode(b"##", [2])
        hdr = bytes.fromhex("0500" + "0000" + "34" + "01" + "a5" + "0f"
                            + "af" + "23" + "10103f")
        assert enc[: len(hdr)] == hdr
        assert fqzcomp.decode(enc, 2) == b"##"
