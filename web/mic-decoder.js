/**
 * mic-decoder.js — zero-dependency browser/JS decoder for the MIC format
 * family (the delivery-tier analog of the reference web/mic-decoder.js,
 * re-implemented from the format contract in docs/formats.md and the
 * mic host tier; reference behaviors cited per function).
 *
 * Scope (matches the reference JS decoder, plus rANS-8 and PICA):
 *   entropy: FSE 1/2/4/8-state auto-dispatch (fse2state.go:96-116),
 *            8-state rANS (rans8state.go:223)
 *   pixels:  16-bit RLE, Delta+RLE inversion (avg/grad/med/zz),
 *            temporal delta, YCoCg-R inverse
 *   files:   MIC1, PICS, PICA, MIC2 (spatial+temporal), MIC3 (WSI tiles,
 *            levels, regions), MICR
 *
 * Design notes (differs deliberately from the reference JS):
 *   - No BigInt: the reverse bit reader loads 32-bit little-endian
 *     windows at byte granularity (reads are <= 16 bits, so shift+width
 *     <= 23 < 32 always holds).  BigInt was the reference's biggest JS
 *     slowdown (web/README.md:92).
 *   - Two-pass frame decode (entropy -> full RLE expansion -> predictor
 *     inversion) like the C tier, not per-pixel pull like the Go tier.
 *
 * Works in browsers, workers, and Node (module.exports at the bottom).
 */
'use strict';

const MICDecoder = (() => {

// ─────────────────────────── bit I/O ───────────────────────────

/**
 * Reverse bit reader for FSE/rANS streams: LSB-first stream read from
 * the last byte backwards; the final byte's highest set bit is the end
 * mark (bitwriter.go:162-168, bitreader.go:26-47).
 *
 * `pos` counts usable bits remaining.  getBits(n) returns the top n
 * unread bits.  Over-reads past the start zero-fill, matching the host
 * tier's exhausted-stream semantics.
 */
class ReverseBitReader {
  constructor(bytes) {
    if (bytes.length < 1 || bytes[bytes.length - 1] === 0) {
      throw new Error('corrupt stream, did not find end of stream');
    }
    this.b = bytes;
    const last = bytes[bytes.length - 1];
    this.pos = 8 * (bytes.length - 1) + (31 - Math.clz32(last));
  }

  _u32(byteOff) {
    // Little-endian 32-bit load, zero-extended past the end.
    const b = this.b;
    return (
      (b[byteOff] | 0) |
      ((b[byteOff + 1] | 0) << 8) |
      ((b[byteOff + 2] | 0) << 16) |
      ((b[byteOff + 3] | 0) << 24)
    ) >>> 0;
  }

  getBits(n) {
    if (n === 0) return 0;
    const pos = this.pos - n;
    this.pos = pos;
    const mask = (1 << n) - 1;
    if (pos < 0) {
      if (pos <= -n) return 0;
      // Low -pos bits are zero-fill; the rest come from the stream base.
      return ((this._u32(0) << -pos) & mask) >>> 0;
    }
    return ((this._u32(pos >> 3) >>> (pos & 7)) & mask) >>> 0;
  }
}

// ─────────────────────── FSE header + tables ───────────────────────

const MIN_TABLE_LOG = 5;
const TABLELOG_ABSOLUTE_MAX = 16;
const MAX_SYMBOL_VALUE = 65535;
const DECOMPRESS_LIMIT = (2 << 30) - 1;

/**
 * Parse a normalized-count header (fsedecompressu16.go:48-167).
 * Returns {norm: Int32Array, symbolLen, tableLog, consumed}.
 */
function readNCount(bytes) {
  const iend = bytes.length;
  if (iend < 4) throw new Error('fse: input too small');
  // Pad so 4-byte loads near the end zero-extend like the host tier's
  // short-slice reads.
  const buf = new Uint8Array(iend + 4);
  buf.set(bytes);
  const dv = new DataView(buf.buffer);
  const u32 = (off) => dv.getUint32(off, true);

  let off = 0;
  let bitStream = u32(off);
  let nbBits = (bitStream & 0xF) + MIN_TABLE_LOG;
  if (nbBits > TABLELOG_ABSOLUTE_MAX) throw new Error('fse: tableLog too large');
  bitStream >>>= 4;
  let bitCount = 4;

  const tableLog = nbBits;
  let remaining = (1 << nbBits) + 1;
  let threshold = 1 << nbBits;
  let gotTotal = 0;
  nbBits++;

  const norm = new Int32Array(MAX_SYMBOL_VALUE + 1);
  let charnum = 0;
  let previous0 = false;

  while (remaining > 1) {
    if (previous0) {
      let n0 = charnum;
      while ((bitStream & 0xFFFF) === 0xFFFF) {
        n0 += 24;
        if (off < iend - 5) {
          off += 2;
          bitStream = u32(off) >>> bitCount;
        } else {
          bitStream >>>= 16;
          bitCount += 16;
        }
      }
      while ((bitStream & 3) === 3) {
        n0 += 3;
        bitStream >>>= 2;
        bitCount += 2;
      }
      n0 += bitStream & 3;
      bitCount += 2;
      if (n0 > MAX_SYMBOL_VALUE) throw new Error('fse: maxSymbolValue too small');
      while (charnum < n0) {
        norm[charnum & 0xFFFF] = 0;
        charnum++;
      }
      if (off <= iend - 7 || off + (bitCount >> 3) <= iend - 4) {
        off += bitCount >> 3;
        bitCount &= 7;
        bitStream = u32(off) >>> bitCount;
      } else {
        bitStream >>>= 2;
      }
    }

    const maxv = (2 * threshold - 1) - remaining;
    let count;
    if ((bitStream & (threshold - 1)) < maxv) {
      count = bitStream & (threshold - 1);
      bitCount += nbBits - 1;
    } else {
      count = bitStream & (2 * threshold - 1);
      if (count >= threshold) count -= maxv;
      bitCount += nbBits;
    }

    count--; // extra accuracy bit
    if (count < 0) {
      remaining += count;
      gotTotal -= count;
    } else {
      remaining -= count;
      gotTotal += count;
    }
    norm[charnum & 0xFFFF] = count;
    charnum++;
    previous0 = count === 0;
    while (remaining < threshold) {
      nbBits--;
      threshold >>= 1;
    }

    if (off <= iend - 7 || off + (bitCount >> 3) <= iend - 4) {
      off += bitCount >> 3;
      bitCount &= 7;
    } else {
      bitCount -= 8 * (iend - 4 - off);
      off = iend - 4;
    }
    bitStream = u32(off) >>> (bitCount & 31);
  }

  const symbolLen = charnum;
  if (symbolLen <= 1) throw new Error('fse: symbolLen too small');
  if (symbolLen > MAX_SYMBOL_VALUE + 1) throw new Error('fse: symbolLen too big');
  if (remaining !== 1) throw new Error('fse: corruption (remaining != 1)');
  if (bitCount > 32) throw new Error('fse: corruption (bitCount > 32)');
  if (gotTotal !== (1 << tableLog)) throw new Error('fse: corruption (bad total)');
  off += (bitCount + 7) >> 3;
  return { norm: norm.subarray(0, symbolLen), symbolLen, tableLog, consumed: off };
}

function highBit(v) {
  return 31 - Math.clz32(v);
}

/**
 * Build the tANS decode table (fsedecompressu16.go:198-263): low-prob
 * symbols at the table top, the rest spread by the co-prime step walk;
 * per slot newState = (nextState << nb) - tableSize.
 * Returns {newState: Uint32Array, symbol: Uint16Array, nbBits: Uint8Array}.
 */
function buildDtable(norm, symbolLen, tableLog) {
  const tableSize = 1 << tableLog;
  const tableSymbol = new Uint16Array(tableSize);
  let highThreshold = tableSize - 1;
  for (let s = 0; s < symbolLen; s++) {
    if (norm[s] === -1) {
      tableSymbol[highThreshold] = s;
      highThreshold--;
    }
  }
  const step = (tableSize >> 1) + (tableSize >> 3) + 3; // fseu16.go:166-168
  const mask = tableSize - 1;
  let position = 0;
  for (let s = 0; s < symbolLen; s++) {
    const v = norm[s];
    for (let j = 0; j < v; j++) {
      tableSymbol[position] = s;
      position = (position + step) & mask;
      while (position > highThreshold) position = (position + step) & mask;
    }
  }
  if (position !== 0) throw new Error('fse: corrupted input (position != 0)');

  const symbolNext = new Uint32Array(symbolLen);
  for (let s = 0; s < symbolLen; s++) {
    symbolNext[s] = norm[s] === -1 ? 1 : Math.max(norm[s], 0);
  }
  const newState = new Uint32Array(tableSize);
  const nbBits = new Uint8Array(tableSize);
  for (let u = 0; u < tableSize; u++) {
    const sym = tableSymbol[u];
    const nextState = symbolNext[sym]++;
    const nb = tableLog - highBit(nextState);
    nbBits[u] = nb;
    const ns = (nextState << nb) - tableSize;
    if (ns < 0 || ns >= tableSize) throw new Error('fse: newState outside table');
    newState[u] = ns;
  }
  return { newState, symbol: tableSymbol, nbBits };
}

/**
 * Linear-fill rANS decode table (ransu16.go:77-135): slots assigned
 * sequentially, norm>0 symbols first (x_next = freq+j), then low-prob
 * symbols with x_next = 1.  Decode-step shape matches tANS.
 */
function buildRansDtable(norm, symbolLen, tableLog) {
  const tableSize = 1 << tableLog;
  const newState = new Uint32Array(tableSize);
  const symbol = new Uint16Array(tableSize);
  const nbBits = new Uint8Array(tableSize);
  let slot = 0;
  for (let s = 0; s < symbolLen; s++) {
    const f = norm[s];
    if (f <= 0) continue;
    for (let j = 0; j < f; j++) {
      const xNext = f + j;
      const nb = tableLog - highBit(xNext);
      symbol[slot] = s;
      nbBits[slot] = nb;
      newState[slot] = (xNext << nb) - tableSize;
      slot++;
    }
  }
  for (let s = 0; s < symbolLen; s++) {
    if (norm[s] !== -1) continue;
    symbol[slot] = s;
    nbBits[slot] = tableLog;
    newState[slot] = 0;
    slot++;
  }
  if (slot !== tableSize) throw new Error('rans: table fill mismatch');
  return { newState, symbol, nbBits };
}

// ─────────────────────── entropy decode ───────────────────────

/**
 * Generic N-lane forward decode (fse{2,4,8}state.go decompress loops).
 * `count` given: counted round-robin decode.  `count` null: 1-state
 * implicit termination (fsedecompressu16.go:362-375).
 */
function decodeBitstream(bytes, dt, tableLog, nStates, count) {
  const r = new ReverseBitReader(bytes);
  const ns = dt.newState, sym = dt.symbol, nb = dt.nbBits;

  if (count !== null) {
    if (count > DECOMPRESS_LIMIT) throw new Error('fse: count > DecompressLimit');
    const states = new Uint32Array(nStates);
    for (let l = 0; l < nStates; l++) states[l] = r.getBits(tableLog);
    const out = new Uint16Array(count);
    let lane = 0;
    for (let i = 0; i < count; i++) {
      const x = states[lane];
      out[i] = sym[x];
      states[lane] = ns[x] + r.getBits(nb[x]);
      lane++;
      if (lane === nStates) lane = 0;
    }
    return out;
  }

  let x = r.getBits(tableLog);
  const out = [];
  for (;;) {
    if (r.pos <= 0 && nb[x] > 0) {
      if (x !== 0) out.push(sym[x]);
      break;
    }
    out.push(sym[x]);
    x = ns[x] + r.getBits(nb[x]);
    if (out.length > DECOMPRESS_LIMIT) throw new Error('fse: output > DecompressLimit');
  }
  return Uint16Array.from(out);
}

function fseDecompressBody(bytes, nStates, count) {
  const h = readNCount(bytes);
  const dt = buildDtable(h.norm, h.symbolLen, h.tableLog);
  return decodeBitstream(bytes.subarray(h.consumed), dt, h.tableLog, nStates, count);
}

function ransDecompress8(bytes) {
  // [FF 08][count u32][header][bits] (rans8state.go:223)
  const count = readU32(bytes, 2);
  const body = bytes.subarray(6);
  const h = readNCount(body);
  const dt = buildRansDtable(h.norm, h.symbolLen, h.tableLog);
  return decodeBitstream(body.subarray(h.consumed), dt, h.tableLog, 8, count);
}

/**
 * Magic-byte auto dispatch (FSEDecompressU16Auto, fse2state.go:96-116):
 * FF 84 -> FSE-8, FF 08 -> rANS-8, FF 04 -> FSE-4, FF 02 -> FSE-2,
 * anything else -> 1-state FSE with implicit count.
 */
function fseDecompressAuto(bytes) {
  if (bytes.length >= 6 && bytes[0] === 0xFF) {
    const m = bytes[1];
    if (m === 0x84) return fseDecompressBody(bytes.subarray(6), 8, readU32(bytes, 2));
    if (m === 0x08) return ransDecompress8(bytes);
    if (m === 0x04) return fseDecompressBody(bytes.subarray(6), 4, readU32(bytes, 2));
    if (m === 0x02) return fseDecompressBody(bytes.subarray(6), 2, readU32(bytes, 2));
  }
  return fseDecompressBody(bytes, 1, null);
}

// ─────────────────────── RLE + predictors ───────────────────────

/**
 * Expand RLE blocks starting at syms[start] (rledecompressu16.go:32-48):
 * count <= midCount => same-run (value follows), count > midCount =>
 * literal run of count-midCount symbols.  count == midCount is never
 * written by the encoder.
 */
function rleExpand(syms, start, midCount, expectLen) {
  const cap = expectLen !== null ? expectLen : syms.length * 4;
  let out = new Uint16Array(cap);
  let o = 0;
  let i = start;
  const n = syms.length;
  const grow = (need) => {
    const next = new Uint16Array(Math.max(out.length * 2, o + need));
    next.set(out.subarray(0, o));
    out = next;
  };
  while (i < n) {
    const c = syms[i++];
    if (c > midCount) {
      const k = Math.min(c - midCount, n - i);
      if (o + k > out.length) grow(k);
      out.set(syms.subarray(i, i + k), o);
      o += k;
      i += k;
    } else {
      if (i >= n) break;
      const v = syms[i++];
      if (o + c > out.length) grow(c);
      out.fill(v, o, o + c);
      o += c;
    }
  }
  return out.subarray(0, o);
}

/** Standalone RLE stream: maxValue word + 32-bit length as two words
 * (rlecompressu16.go:85-93). */
function rleDecompress(syms) {
  const maxValue = syms[0];
  const depth = maxValue === 0 ? 1 : highBit(maxValue) + 1; // depth floors at 1
  const midCount = (1 << (depth - 1)) - 1;
  const outLen = (syms[1] << 16) + syms[2];
  const out = rleExpand(syms, 3, midCount, outLen);
  if (out.length < outLen) throw new Error('rle: truncated stream');
  return out.subarray(0, outLen);
}

function gradPredict(w, n, nw, ne) {
  // deltagradcompressu16.go:149-166, gradShift=3.
  const avg = (w + n) >> 1;
  const gw = Math.abs(w - nw);
  const gn = Math.abs(n - nw);
  const g = gw + gn;
  if (g === 0) return avg;
  let corr = (ne - nw) >> 3;
  const lim = g >> 1;
  if (corr > lim) corr = lim;
  if (corr < -lim) corr = -lim;
  return avg + corr;
}

function medPredict(a, b, c) {
  // deltamedcompressu16.go:133-147 (JPEG-LS median edge detector).
  if (c >= a && c >= b) return Math.min(a, b);
  if (c <= a && c <= b) return Math.max(a, b);
  return a + b - c;
}

/**
 * Invert the escaped residual token stream into pixels (two-pass shape,
 * like the C tier): tokens[0] is the image maxValue; thereafter one
 * token per pixel, `delim` followed by a raw pixel for escapes
 * (deltacompressu16.go:54-120 and grad/med/zz variants).
 */
function predictorInverse(tokens, width, height, kind) {
  if (tokens.length < width * height + 1) throw new Error('delta: short token stream');
  const maxValue = tokens[0];
  const depth = maxValue === 0 ? 1 : highBit(maxValue) + 1;
  const thr = (1 << (depth - 1)) - 1;
  const delim = (1 << depth) - 1;
  const out = new Uint16Array(width * height);
  let ti = 1;

  if (kind === 'zz') {
    // Left-neighbour ZigZag rows (deltazigzagcompressu16.go:20-106).
    for (let y = 0; y < height; y++) {
      const row = y * width;
      let prev = 0;
      for (let x = 0; x < width; x++) {
        const v = tokens[ti++];
        if (v === delim) {
          prev = tokens[ti++];
        } else {
          prev = (prev + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
        }
        out[row + x] = prev;
      }
    }
    return out;
  }

  // Row 0: left-only chain.
  {
    const t0 = tokens[ti++];
    out[0] = t0 === delim ? tokens[ti++] : (t0 - thr) & 0xFFFF;
    for (let x = 1; x < width; x++) {
      const t = tokens[ti++];
      out[x] = t === delim ? tokens[ti++] : (out[x - 1] + t - thr) & 0xFFFF;
    }
  }
  for (let y = 1; y < height; y++) {
    const row = y * width;
    {
      const t = tokens[ti++];
      out[row] = t === delim ? tokens[ti++] : (out[row - width] + t - thr) & 0xFFFF;
    }
    let left = out[row];
    if (kind === 'avg') {
      for (let x = 1; x < width; x++) {
        const t = tokens[ti++];
        if (t === delim) {
          left = tokens[ti++];
        } else {
          left = (((left + out[row - width + x]) >> 1) + t - thr) & 0xFFFF;
        }
        out[row + x] = left;
      }
    } else if (kind === 'grad') {
      for (let x = 1; x < width; x++) {
        const t = tokens[ti++];
        if (t === delim) {
          left = tokens[ti++];
        } else {
          const up = out[row - width + x];
          const nw = out[row - width + x - 1];
          const ne = x + 1 < width ? out[row - width + x + 1] : nw;
          left = (gradPredict(left, up, nw, ne) + t - thr) & 0xFFFF;
        }
        out[row + x] = left;
      }
    } else { // med
      for (let x = 1; x < width; x++) {
        const t = tokens[ti++];
        if (t === delim) {
          left = tokens[ti++];
        } else {
          const up = out[row - width + x];
          const nw = out[row - width + x - 1];
          left = (medPredict(left, up, nw) + t - thr) & 0xFFFF;
        }
        out[row + x] = left;
      }
    }
  }
  return out;
}

/**
 * Canonical single-frame decode (DecompressSingleFrame,
 * multiframecompress.go:97-107): entropy auto-dispatch -> RLE expand
 * (fused layout: leading maxValue word, no length) -> predictor invert.
 */
function decodeFrame(bytes, width, height, kind) {
  const rle = fseDecompressAuto(bytes);
  const maxValue = rle[0];
  const depth = maxValue === 0 ? 1 : highBit(maxValue) + 1; // depth floors at 1
  const midCount = (1 << (depth - 1)) - 1;
  const tokens = rleExpand(rle, 1, midCount, null);
  // tokens[0] after expansion is the image maxValue (the first Encode'd
  // symbol, deltarlecompressu16.go:29).
  return predictorInverse(tokens, width, height, kind || 'avg');
}

/** Temporal residual decode: RLE stream (with length) of ZigZag diffs
 * added mod 2^16 to the previous frame (temporaldelta.go:27-39). */
function temporalDecode(residualBlob, prev) {
  const rle = fseDecompressAuto(residualBlob);
  const residuals = rleDecompress(rle);
  const out = new Uint16Array(residuals.length);
  for (let i = 0; i < residuals.length; i++) {
    const v = residuals[i];
    out[i] = (prev[i] + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
  }
  return out;
}

// ─────────────────────── color ───────────────────────

/** YCoCg-R inverse: planes (Y, ZigZag Co, ZigZag Cg) -> RGB bytes
 * (ycocgr.go:30-35). */
function ycocgrInverse(y, co, cg, n) {
  const out = new Uint8Array(n * 3);
  for (let i = 0; i < n; i++) {
    const cov = (co[i] >>> 1) ^ -(co[i] & 1);
    const cgv = (cg[i] >>> 1) ^ -(cg[i] & 1);
    const t = y[i] - (cgv >> 1);
    const g = cgv + t;
    const b = t - (cov >> 1);
    const r = cov + b;
    out[i * 3] = r;
    out[i * 3 + 1] = g;
    out[i * 3 + 2] = b;
  }
  return out;
}

// ─────────────────────── containers ───────────────────────

function readU32(bytes, off) {
  return (bytes[off] | (bytes[off + 1] << 8) | (bytes[off + 2] << 16) |
          (bytes[off + 3] << 24)) >>> 0;
}
function readU16(bytes, off) {
  return bytes[off] | (bytes[off + 1] << 8);
}
function readU64(bytes, off) {
  // Offsets/lengths < 2^53 in practice; high word folded via * 2^32.
  return readU32(bytes, off) + readU32(bytes, off + 4) * 4294967296;
}
function magic(bytes) {
  return String.fromCharCode(bytes[0], bytes[1], bytes[2], bytes[3]);
}

/** MIC1: magic | w u32 | h u32 | pipeline u32 | len u32 | payload. */
function decodeMIC1(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const len = readU32(bytes, 16);
  if (20 + len > bytes.length) throw new Error('MIC1: truncated');
  const pixels = decodeFrame(bytes.subarray(20, 20 + len), width, height, 'avg');
  return { pixels, width, height, format: 'MIC1' };
}

/** PICS: magic | w | h | numStrips | stripH | (off,len)* | blobs
 * (parallelstrips.go:21-28). */
function parsePICSHeader(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const numStrips = readU32(bytes, 12);
  const stripHeight = readU32(bytes, 16);
  const dataOffset = 20 + numStrips * 8;
  if (bytes.length < dataOffset) throw new Error('PICS: truncated table');
  const strips = [];
  for (let s = 0; s < numStrips; s++) {
    strips.push({
      offset: readU32(bytes, 20 + s * 8),
      length: readU32(bytes, 20 + s * 8 + 4),
    });
  }
  return { width, height, numStrips, stripHeight, strips, dataOffset };
}

function decodePICS(bytes) {
  const h = parsePICSHeader(bytes);
  const out = new Uint16Array(h.width * h.height);
  for (let s = 0; s < h.numStrips; s++) {
    const y0 = s * h.stripHeight;
    const sh = Math.min(h.stripHeight, h.height - y0);
    const e = h.strips[s];
    const blob = bytes.subarray(h.dataOffset + e.offset, h.dataOffset + e.offset + e.length);
    out.set(decodeFrame(blob, h.width, sh, 'avg'), y0 * h.width);
  }
  return { pixels: out, width: h.width, height: h.height, format: 'PICS', numStrips: h.numStrips };
}

/** PICA adaptive strips: 16-byte entries y0/off/len/flags, flags bit0 =
 * gradient predictor (parallelstripsadaptive.go:28-47). */
function decodePICA(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const numStrips = readU32(bytes, 12);
  const base = 16;
  const dataOffset = base + numStrips * 16;
  const out = new Uint16Array(width * height);
  for (let s = 0; s < numStrips; s++) {
    const y0 = readU32(bytes, base + s * 16);
    const off = readU32(bytes, base + s * 16 + 4);
    const len = readU32(bytes, base + s * 16 + 8);
    const flags = readU32(bytes, base + s * 16 + 12);
    const y1 = s + 1 < numStrips ? readU32(bytes, base + (s + 1) * 16) : height;
    const blob = bytes.subarray(dataOffset + off, dataOffset + off + len);
    const kind = (flags & 1) ? 'grad' : 'avg';
    out.set(decodeFrame(blob, width, y1 - y0, kind), y0 * width);
  }
  return { pixels: out, width, height, format: 'PICA', numStrips };
}

/** MIC2 multi-frame: magic | w | h | frames | flags u8 + 3 pad |
 * (off,len)* | blobs; flags 1=spatial 2=temporal (multiframe.go:14-32). */
function parseMIC2Header(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const frameCount = readU32(bytes, 12);
  const flags = bytes[16];
  const temporal = (flags & 2) !== 0;
  const base = 20;
  const dataOffset = base + frameCount * 8;
  const frames = [];
  for (let i = 0; i < frameCount; i++) {
    frames.push({
      offset: readU32(bytes, base + i * 8),
      length: readU32(bytes, base + i * 8 + 4),
    });
  }
  return { width, height, frameCount, temporal, frames, dataOffset };
}

function extractMIC2Frame(bytes, hdr, idx) {
  const e = hdr.frames[idx];
  return bytes.subarray(hdr.dataOffset + e.offset, hdr.dataOffset + e.offset + e.length);
}

/** Decode one MIC2 frame payload (host or MICW device format). */
function decodeMIC2Payload(blob, width, height) {
  return magic(blob) === 'MICW'
    ? decodeMICW(blob).pixels
    : decodeFrame(blob, width, height, 'avg');
}

/** Decode frame `idx`; temporal mode decodes 0..idx sequentially
 * (multiframecompress.go:227-315; device frames are MICW blobs). */
function decodeMIC2Frame(bytes, idx, hdr) {
  hdr = hdr || parseMIC2Header(bytes);
  if (idx >= hdr.frameCount) throw new Error('MIC2: frame out of range');
  if (!hdr.temporal) {
    return decodeMIC2Payload(extractMIC2Frame(bytes, hdr, idx), hdr.width, hdr.height);
  }
  let prev = decodeMIC2Payload(extractMIC2Frame(bytes, hdr, 0), hdr.width, hdr.height);
  for (let i = 1; i <= idx; i++) {
    const blob = extractMIC2Frame(bytes, hdr, i);
    if (magic(blob) === 'MICW') {
      const res = decodeMICW(blob).pixels;
      const px = new Uint16Array(res.length);
      for (let k = 0; k < res.length; k++) {
        const v = res[k];
        px[k] = (prev[k] + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
      }
      prev = px;
    } else {
      prev = temporalDecode(blob, prev);
    }
  }
  return prev;
}

function decodeMIC2(bytes) {
  const hdr = parseMIC2Header(bytes);
  const frames = [];
  let prev = null;
  for (let i = 0; i < hdr.frameCount; i++) {
    const blob = extractMIC2Frame(bytes, hdr, i);
    let px;
    const isMicw = magic(blob) === 'MICW';
    if (hdr.temporal && i > 0) {
      if (isMicw) {
        // Device temporal mode: the residual plane is a MICW blob of raw
        // ZigZag diffs (multiframe.py compress_multi_frame_device).
        const res = decodeMICW(blob).pixels;
        px = new Uint16Array(res.length);
        for (let k = 0; k < res.length; k++) {
          const v = res[k];
          px[k] = (prev[k] + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
        }
      } else {
        px = temporalDecode(blob, prev);
      }
    } else if (isMicw) {
      px = decodeMICW(blob).pixels;
    } else {
      px = decodeFrame(blob, hdr.width, hdr.height, 'avg');
    }
    frames.push(px);
    prev = px;
  }
  return { frames, width: hdr.width, height: hdr.height,
           frameCount: hdr.frameCount, temporal: hdr.temporal, format: 'MIC2' };
}

/** Plane blob: mode byte 0=const-zero, 1=const u16, 2=compressed,
 * 3=raw u16 (wsicompress.go:17-22, 373-421). */
function decodePlane(bytes, width, height, n) {
  if (bytes.length === 0) throw new Error('plane: empty');
  const mode = bytes[0];
  if (mode === 0) return new Uint16Array(n);
  if (mode === 1) {
    const out = new Uint16Array(n);
    out.fill(readU16(bytes, 1));
    return out;
  }
  if (mode === 2) return decodeFrame(bytes.subarray(1), width, height, 'avg');
  if (mode === 3) {
    const out = new Uint16Array(n);
    for (let i = 0; i < n; i++) out[i] = readU16(bytes, 1 + i * 2);
    return out;
  }
  throw new Error('plane: unknown mode ' + mode);
}

/** RGB blob: [Ylen][Colen][Cglen] u32 + three plane blobs
 * (rgbcompress.go:18-24). */
function decodeRGBBlob(bytes, width, height, colorTransform) {
  const yLen = readU32(bytes, 0);
  const coLen = readU32(bytes, 4);
  const cgLen = readU32(bytes, 8);
  const n = width * height;
  let off = 12;
  const y = decodePlane(bytes.subarray(off, off + yLen), width, height, n); off += yLen;
  const co = decodePlane(bytes.subarray(off, off + coLen), width, height, n); off += coLen;
  const cg = decodePlane(bytes.subarray(off, off + cgLen), width, height, n);
  if (!colorTransform) {
    const out = new Uint8Array(n * 3);
    for (let i = 0; i < n; i++) {
      out[i * 3] = y[i];
      out[i * 3 + 1] = co[i];
      out[i * 3 + 2] = cg[i];
    }
    return out;
  }
  return ycocgrInverse(y, co, cg, n);
}

/** MICR single-frame RGB: magic | w | h | RGB blob (always
 * color-transformed, rgbcompress.go:25-33). */
function decodeMICR(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const rgb = decodeRGBBlob(bytes.subarray(12), width, height, true);
  return { rgb, width, height, channels: 3, format: 'MICR' };
}

/** MIC3 WSI: 48-byte header + level descriptors + (off,len u64) tile
 * table (wsiformat.go:14-48). */
function parseMIC3Header(bytes) {
  const version = readU32(bytes, 4);
  const width = readU32(bytes, 8);
  const height = readU32(bytes, 12);
  const tileWidth = readU32(bytes, 16);
  const tileHeight = readU32(bytes, 20);
  const channels = readU16(bytes, 24);
  const bitsPerSample = bytes[26];
  const flags = bytes[27];
  const colorTransform = (flags & 2) !== 0;
  const levelCount = readU16(bytes, 28);
  const totalTiles = readU64(bytes, 32);
  let pos = 48;
  const levels = [];
  for (let l = 0; l < levelCount; l++) {
    levels.push({
      width: readU32(bytes, pos),
      height: readU32(bytes, pos + 4),
      tilesX: readU32(bytes, pos + 8),
      tilesY: readU32(bytes, pos + 12),
      firstTileIdx: readU32(bytes, pos + 16),
    });
    pos += 20;
  }
  const tileTable = [];
  for (let t = 0; t < totalTiles; t++) {
    tileTable.push({ offset: readU64(bytes, pos), length: readU64(bytes, pos + 8) });
    pos += 16;
  }
  return { version, width, height, tileWidth, tileHeight, channels,
           bitsPerSample, colorTransform, levelCount, levels, tileTable,
           dataOffset: pos, totalTiles, format: 'MIC3' };
}

/** Decode one tile -> interleaved samples (RGB bytes or grey u16),
 * full tile size incl. edge padding (wsicompress.go:175-216). */
function decodeMIC3Tile(bytes, hdr, level, tx, ty) {
  const lv = hdr.levels[level];
  if (!lv || tx >= lv.tilesX || ty >= lv.tilesY) throw new Error('MIC3: tile out of range');
  const idx = lv.firstTileIdx + ty * lv.tilesX + tx;
  const e = hdr.tileTable[idx];
  const blob = bytes.subarray(hdr.dataOffset + e.offset, hdr.dataOffset + e.offset + e.length);
  const tw = hdr.tileWidth, th = hdr.tileHeight;
  if (hdr.channels === 3) {
    return decodeRGBBlob(blob, tw, th, hdr.colorTransform);
  }
  return decodePlane(blob, tw, th, tw * th);
}

/** Assemble a full pyramid level (crops edge-tile padding). */
function decodeMIC3Level(bytes, hdr, level) {
  const lv = hdr.levels[level];
  const ch = hdr.channels;
  const out = ch === 3 ? new Uint8Array(lv.width * lv.height * 3)
                       : new Uint16Array(lv.width * lv.height);
  for (let ty = 0; ty < lv.tilesY; ty++) {
    for (let tx = 0; tx < lv.tilesX; tx++) {
      const tile = decodeMIC3Tile(bytes, hdr, level, tx, ty);
      const x0 = tx * hdr.tileWidth, y0 = ty * hdr.tileHeight;
      const cw = Math.min(hdr.tileWidth, lv.width - x0);
      const chgt = Math.min(hdr.tileHeight, lv.height - y0);
      for (let r = 0; r < chgt; r++) {
        const src = (r * hdr.tileWidth) * ch;
        const dst = ((y0 + r) * lv.width + x0) * ch;
        out.set(tile.subarray(src, src + cw * ch), dst);
      }
    }
  }
  return { pixels: out, width: lv.width, height: lv.height, channels: ch };
}

/** Cross-tile region decode at a level (wsicompress.go:220-296). */
function decodeMIC3Region(bytes, hdr, level, x, y, w, h) {
  const lv = hdr.levels[level];
  if (x + w > lv.width || y + h > lv.height) throw new Error('MIC3: region out of bounds');
  const ch = hdr.channels;
  const out = ch === 3 ? new Uint8Array(w * h * 3) : new Uint16Array(w * h);
  const tx0 = Math.floor(x / hdr.tileWidth), tx1 = Math.floor((x + w - 1) / hdr.tileWidth);
  const ty0 = Math.floor(y / hdr.tileHeight), ty1 = Math.floor((y + h - 1) / hdr.tileHeight);
  for (let ty = ty0; ty <= ty1; ty++) {
    for (let tx = tx0; tx <= tx1; tx++) {
      const tile = decodeMIC3Tile(bytes, hdr, level, tx, ty);
      const tileX = tx * hdr.tileWidth, tileY = ty * hdr.tileHeight;
      const ix0 = Math.max(x, tileX), ix1 = Math.min(x + w, tileX + hdr.tileWidth);
      const iy0 = Math.max(y, tileY), iy1 = Math.min(y + h, tileY + hdr.tileHeight);
      for (let r = iy0; r < iy1; r++) {
        const src = ((r - tileY) * hdr.tileWidth + (ix0 - tileX)) * ch;
        const dst = ((r - y) * w + (ix0 - x)) * ch;
        out.set(tile.subarray(src, src + (ix1 - ix0) * ch), dst);
      }
    }
  }
  return { pixels: out, width: w, height: h, channels: ch };
}

// ─────────────────── device formats (MICT/MICW/MWR3) ───────────────────

/**
 * Parse a MICT wide-lane rANS stream (docs/formats.md "MICT entropy
 * stream"): FF 57 | log2lanes u8 | tableLog u8 | count u32 | nWords u32
 * | normalized-count header | initStates L*u32 | words nWords*u16.
 */
function mictParse(bytes) {
  const isAlias = bytes.length >= 2 && bytes[0] === 0xFF && bytes[1] === 0x41;
  if (bytes.length < 12 || bytes[0] !== 0xFF ||
      (bytes[1] !== 0x57 && bytes[1] !== 0x41)) {
    throw new Error('MICT: missing magic');
  }
  const lanes = 1 << bytes[2];
  const tlHdr = bytes[3];
  const count = readU32(bytes, 4);
  const nWords = readU32(bytes, 8);
  let hdr = 12, nEsc = 0, escVal = 0;
  if (isAlias) {            // FF 41: | nEsc u32 | escVal u16 | ...
    nEsc = readU32(bytes, 12);
    escVal = readU16(bytes, 16);
    hdr = 18;
  }
  const h = readNCount(bytes.subarray(hdr));
  if (h.tableLog !== tlHdr) throw new Error('MICT: tableLog mismatch');
  let pos = hdr + h.consumed;
  const states = new Float64Array(lanes); // u32 values; Number math below
  for (let l = 0; l < lanes; l++) { states[l] = readU32(bytes, pos); pos += 4; }
  const words = new Uint16Array(nWords);
  for (let w = 0; w < nWords; w++) { words[w] = readU16(bytes, pos); pos += 2; }
  let escValues = null;
  if (isAlias) {
    if (pos + 2 * nEsc > bytes.length) throw new Error('MICT: escape stream out of bounds');
    escValues = new Uint16Array(nEsc);
    for (let i = 0; i < nEsc; i++) { escValues[i] = readU16(bytes, pos); pos += 2; }
  }
  return { lanes, tableLog: h.tableLog, count, states, words,
           norm: h.norm, symbolLen: h.symbolLen,
           alias: isAlias ? { escVal, escValues } : null };
}

/**
 * Per-slot (sym, freq, bias) tables for an alias-mapped (FF 41) stream:
 * the deterministic integer Vose layout of device_rans.alias_construct
 * (128 buckets of K = 2^(tl-7) slots, primary run then alias run),
 * expanded to slot-indexed arrays so the decode loop is unchanged.
 */
function aliasSlotTables(norm, symbolLen, tableLog) {
  const M = 1 << tableLog;
  const K = M >> 7;
  const syms = [], w = [];
  for (let s = 0; s < symbolLen; s++) {
    const f = norm[s] === -1 ? 1 : norm[s];
    if (f > 0) { syms.push(s); w.push(f); }
  }
  if (syms.length > 256) throw new Error('MICT alias: alphabet > 256');
  let wSum = 0;
  for (let i = 0; i < w.length; i++) wSum += w[i];
  if (wSum !== M) throw new Error('MICT alias: freqs do not sum to table size');
  const small = [], large = [];
  for (let i = 0; i < syms.length; i++) (w[i] < K ? small : large).push(i);
  const counter = new Float64Array(syms.length);
  const sym = new Uint16Array(M);
  const freq = new Uint32Array(M);
  const bias = new Uint32Array(M);
  const fOf = w.slice();  // original freqs (w is mutated below)
  for (let b = 0; b < 128; b++) {
    let p, a = -1, t;
    if (small.length) {
      p = small.pop();
      t = w[p];
      w[p] = 0;
      if (large.length) {
        a = large[large.length - 1];
        w[a] -= K - t;
        if (w[a] === 0) large.pop();
        else if (w[a] < K) small.push(large.pop());
      } else {
        if (!small.length) throw new Error('MICT alias: stranded small symbol');
        let ai = 0;
        for (let i = 1; i < small.length; i++) if (w[small[i]] > w[small[ai]]) ai = i;
        a = small[ai];
        if (w[a] < K - t) throw new Error('MICT alias: no alias covers the bucket');
        w[a] -= K - t;
        if (w[a] === 0) small.splice(ai, 1);
      }
    } else {
      if (!large.length) throw new Error('MICT alias: stacks exhausted before all buckets filled');
      p = large[large.length - 1];
      t = K;
      a = p;
      w[p] -= K;
      if (w[p] === 0) large.pop();
      else if (w[p] < K) small.push(large.pop());
    }
    const base = b * K;
    for (let j = 0; j < t; j++) {
      sym[base + j] = syms[p]; freq[base + j] = fOf[p];
      bias[base + j] = counter[p] + j;
    }
    counter[p] += t;
    if (t < K) {
      for (let j = 0; j < K - t; j++) {
        sym[base + t + j] = syms[a]; freq[base + t + j] = fOf[a];
        bias[base + t + j] = counter[a] + j;
      }
      counter[a] += K - t;
    }
  }
  return { sym, freq, bias };
}

/**
 * Decode a MICT stream (device_rans.py mict_decode_numpy): per lane
 * slot = x & mask; x' = freq[slot]*(x>>tl) + bias[slot]; renormalize
 * from the shared word cursor while x' < 2^16.  Lane of symbol i is
 * i % L.  Every lane must land on state 2^16 exactly.
 */
function mictDecode(bytes) {
  const p = mictParse(bytes);
  const tsize = 1 << p.tableLog;
  const mask = tsize - 1;
  let sym, freq, bias;
  if (p.alias) {
    // FF 41: the slots are permuted into the 128-bucket alias layout.
    ({ sym, freq, bias } = aliasSlotTables(p.norm, p.symbolLen, p.tableLog));
  } else {
    // Slot tables from norm: freqs in symbol order, low-prob (-1) = 1.
    sym = new Uint16Array(tsize);
    freq = new Uint32Array(tsize);
    bias = new Uint32Array(tsize);
    let slot = 0;
    for (let s = 0; s < p.symbolLen; s++) {
      const f = p.norm[s] === -1 ? 1 : p.norm[s];
      for (let j = 0; j < f; j++) {
        sym[slot] = s; freq[slot] = f; bias[slot] = j; slot++;
      }
    }
    if (slot !== tsize) throw new Error('MICT: freqs do not sum to table size');
  }

  const L = p.lanes;
  const x = p.states; // Float64Array of u32 values (exact Number math)
  const out = new Uint16Array(p.count);
  let cursor = 0;
  const steps = Math.ceil(p.count / L);
  for (let t = 0; t < steps; t++) {
    const base = t * L;
    const active = Math.min(L, p.count - base);
    for (let l = 0; l < active; l++) {
      const xi = x[l];
      const sl = (xi >>> 0) & mask;          // exact: xi < 2^32
      out[base + l] = sym[sl];
      let xn = freq[sl] * (xi >>> p.tableLog) + bias[sl]; // < 2^32, exact
      // Exactly one conditional renorm per step (mict_decode_numpy):
      // a valid x' >= 1 lands >= 2^16 after one word; corrupt streams
      // (x' == 0) fall through and fail the final-state check below
      // instead of spinning.
      if (xn < 65536) {
        xn = xn * 65536 + (cursor < p.words.length ? p.words[cursor] : 0);
        cursor++;
      }
      x[l] = xn;
    }
  }
  for (let l = 0; l < L; l++) {
    if (x[l] !== 65536) throw new Error('MICT: final state mismatch');
  }
  if (cursor !== p.words.length) throw new Error('MICT: word count mismatch');
  if (p.alias) {
    // Escape substitution: decoded ESC symbols take their true values
    // from the side stream in stream order (alias_substitute_escapes).
    // Runs even with an empty side stream so a forged nEsc=0 on a
    // stream that decodes ESC placeholders fails instead of silently
    // leaving them in the output.
    let e = 0;
    for (let i = 0; i < out.length; i++) {
      if (out[i] === p.alias.escVal) {
        if (e >= p.alias.escValues.length) throw new Error('MICT: escape count mismatch');
        out[i] = p.alias.escValues[e++];
      }
    }
    if (e !== p.alias.escValues.length) throw new Error('MICT: escape count mismatch');
  }
  return out;
}

/**
 * Direct-mode predictor inverses (strips.py _zzd/_vdd/_pdd_syms
 * inverted): un-ZigZag then mod-2^16 cumsum over rows (zzd), columns
 * (vdd), or both (pdd — the separable W+N-NW plane difference).
 * Writes sh*width pixels at out[base..].
 */
function micwDirectInverse(syms, out, base, width, sh, pred) {
  if (pred === 'zzd' || pred === 'pdd') {
    for (let y = 0; y < sh; y++) {
      let acc = 0;
      for (let xx = 0; xx < width; xx++) {
        const v = syms[y * width + xx];
        acc = (acc + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
        out[base + y * width + xx] = acc;
      }
    }
    if (pred === 'pdd') {
      for (let xx = 0; xx < width; xx++) {
        let acc = 0;
        for (let y = 0; y < sh; y++) {
          acc = (acc + out[base + y * width + xx]) & 0xFFFF;
          out[base + y * width + xx] = acc;
        }
      }
    }
  } else { // vdd
    for (let xx = 0; xx < width; xx++) {
      let acc = 0;
      for (let y = 0; y < sh; y++) {
        const v = syms[y * width + xx];
        acc = (acc + ((v >>> 1) ^ -(v & 1))) & 0xFFFF;
        out[base + y * width + xx] = acc;
      }
    }
  }
}

/** SoA-RLE expansion (ops/rle.py soa_expand): soa = [counts][same
 * values][literals]; count <= mid = same-run, else literal run of
 * count-mid. */
function soaExpand(soa, nRuns, nSame, mid) {
  let total = 0;
  for (let r = 0; r < nRuns; r++) {
    const c = soa[r];
    total += c <= mid ? c : c - mid;
  }
  const out = new Uint16Array(total);
  let o = 0, si = nRuns, li = nRuns + nSame;
  for (let r = 0; r < nRuns; r++) {
    const c = soa[r];
    if (c <= mid) {
      out.fill(soa[si++], o, o + c);
      o += c;
    } else {
      const k = c - mid;
      out.set(soa.subarray(li, li + k), o);
      o += k; li += k;
    }
  }
  return out;
}

const MICW_HEADER = 24;
const MICW_ENTRY = 28;

/** Parse a MICW container (docs/formats.md "MICW container (v4)").
 * FLAG_BANDED (0x08, v5) containers store a wide image as vertically
 * stacked 512-wide column bands (strips.py band_split); an 8-byte
 * origWidth/origHeight extension precedes the strip table. */
function micwParse(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const numStrips = readU32(bytes, 12);
  const stripHeight = readU32(bytes, 16);
  const maxValue = readU16(bytes, 20);
  const flags = bytes[22];
  const lanes = 1 << bytes[23];
  const globalPred = (flags & 2) ? 'zzd' : (flags & 1) ? 'avg' : 'zz';
  const banded = (flags & 8) !== 0;
  let hdr = MICW_HEADER;
  let origWidth = width, origHeight = height;
  if (banded) {
    if (bytes.length < MICW_HEADER + 8) throw new Error('MICW: truncated banded extension');
    origWidth = readU32(bytes, 24);
    origHeight = readU32(bytes, 28);
    hdr += 8;
  }
  if (bytes.length < hdr + numStrips * MICW_ENTRY) throw new Error('MICW: truncated strip table');
  const data0 = hdr + numStrips * MICW_ENTRY;
  const strips = [];
  for (let s = 0; s < numStrips; s++) {
    const e = hdr + s * MICW_ENTRY;
    strips.push({
      off: readU32(bytes, e), len: readU32(bytes, e + 4),
      nSoa: readU32(bytes, e + 8), nTokens: readU32(bytes, e + 12),
      nRuns: readU32(bytes, e + 16), nSame: readU32(bytes, e + 20),
      mode: readU32(bytes, e + 24),
    });
  }
  return { width, height, numStrips, stripHeight, maxValue, globalPred,
           lanes, strips, dataOffset: data0, banded, origWidth, origHeight };
}

/** MICW's RLE midCount: delimiter-derived, floored at 255
 * (mic/device/strips.py _rle_mid). */
function micwMid(maxValue) {
  const depth = maxValue === 0 ? 0 : highBit(maxValue) + 1;
  let delim = (1 << depth) - 1;
  if (delim < 255) delim = 255;
  return (1 << highBit(delim)) - 1;
}

/** Decode a MICW container to pixels (mic/device/strips.py
 * micw_decompress_host).  Strip modes: 0 legacy-global, 1 raw, 2 zzd,
 * 3 zz+SoA-RLE, 4 avg+SoA-RLE, 5 constant, 6 vdd. */
function decodeMICW(bytes) {
  const h = micwParse(bytes);
  const mid = micwMid(h.maxValue);
  const out = new Uint16Array(h.width * h.height);
  for (let s = 0; s < h.numStrips; s++) {
    const e = h.strips[s];
    const y0 = s * h.stripHeight;
    const sh = Math.min(h.stripHeight, h.height - y0);
    const blob = bytes.subarray(h.dataOffset + e.off, h.dataOffset + e.off + e.len);
    const base = y0 * h.width;
    let pred = null;
    if (e.mode === 1) {        // raw
      for (let i = 0; i < sh * h.width; i++) out[base + i] = readU16(blob, i * 2);
      continue;
    } else if (e.mode === 5) { // constant
      out.fill(readU16(blob, 0), base, base + sh * h.width);
      continue;
    } else if (e.mode === 0) {
      pred = h.globalPred;
    } else {
      pred = { 2: 'zzd', 3: 'zz', 4: 'avg', 6: 'vdd', 7: 'pdd',
               8: 'zzr', 9: 'vdr', 10: 'pdr' }[e.mode];
      if (!pred) throw new Error('MICW: unknown strip mode ' + e.mode);
    }
    let syms = mictDecode(blob);
    if (pred === 'zzr' || pred === 'vdr' || pred === 'pdr') {
      // RLE'd-direct (v5): SoA-RLE with the format-constant midCount
      // 16383 (MID_DIRECT) over bijective direct symbols, then the base
      // direct inverse.
      syms = soaExpand(syms, e.nRuns, e.nSame, 16383);
      if (syms.length !== e.nTokens) throw new Error('MICW: r-mode token count mismatch');
      pred = { zzr: 'zzd', vdr: 'vdd', pdr: 'pdd' }[pred];
    }
    if (pred === 'zzd' || pred === 'vdd' || pred === 'pdd') {
      micwDirectInverse(syms, out, base, h.width, sh, pred);
      continue;
    }
    // SoA-RLE modes: expand, then escaped-residual inversion.  tokens[0]
    // is the strip maxValue (== container maxValue by construction).
    const tokens = soaExpand(syms, e.nRuns, e.nSame, mid);
    if (tokens.length !== e.nTokens) throw new Error('MICW: token count mismatch');
    out.set(predictorInverse(tokens, h.width, sh, pred), base);
  }
  if (h.banded) {
    // Un-band: (bands, origHeight, bandW) -> (origHeight, origWidth)
    // row-wise copy (strips.py band_merge).
    const bandW = h.width;
    const bands = (h.origWidth / bandW) | 0;
    const merged = new Uint16Array(h.origWidth * h.origHeight);
    for (let b = 0; b < bands; b++) {
      for (let y = 0; y < h.origHeight; y++) {
        const src = (b * h.origHeight + y) * bandW;
        merged.set(out.subarray(src, src + bandW),
                   y * h.origWidth + b * bandW);
      }
    }
    return { pixels: merged, width: h.origWidth, height: h.origHeight,
             format: 'MICW' };
  }
  return { pixels: out, width: h.width, height: h.height, format: 'MICW' };
}

/** MWR3 device RGB: magic | w | h | 3 x len u32 | 3 MICW plane blobs
 * (Y, ZigZag Co, ZigZag Cg).  A plane blob's own MICW width may exceed
 * the container width (columns edge-padded to a multiple of 128, which
 * an earlier device kernel needed); crop each decoded plane back. */
function decodeMWR3(bytes) {
  const width = readU32(bytes, 4);
  const height = readU32(bytes, 8);
  const lens = [readU32(bytes, 12), readU32(bytes, 16), readU32(bytes, 20)];
  let off = 24;
  const planes = lens.map((len) => {
    const p = decodeMICW(bytes.subarray(off, off + len));
    off += len;
    if (p.width === width) return p.pixels;
    const cropped = new Uint16Array(width * height);
    for (let y = 0; y < height; y++) {
      cropped.set(p.pixels.subarray(y * p.width, y * p.width + width),
                  y * width);
    }
    return cropped;
  });
  const n = width * height;
  return { rgb: ycocgrInverse(planes[0], planes[1], planes[2], n),
           width, height, channels: 3, format: 'MWR3' };
}

// ─────────────────────── top-level dispatch ───────────────────────

/**
 * Decode any MIC-family file by magic.  Returns a format-tagged object;
 * see the per-format decoders for fields.
 */
function decodeMicFile(bytes) {
  if (!(bytes instanceof Uint8Array)) bytes = new Uint8Array(bytes);
  if (bytes.length < 12) throw new Error('not a MIC file (too small)');
  const m = magic(bytes);
  switch (m) {
    case 'MIC1': return decodeMIC1(bytes);
    case 'PICS': return decodePICS(bytes);
    case 'PICA': return decodePICA(bytes);
    case 'MIC2': return decodeMIC2(bytes);
    case 'MIC3': {
      const hdr = parseMIC3Header(bytes);
      const lv0 = decodeMIC3Level(bytes, hdr, 0);
      return Object.assign({ header: hdr, format: 'MIC3' }, lv0);
    }
    case 'MICR': return decodeMICR(bytes);
    case 'MICW': return decodeMICW(bytes);
    case 'MWR3': return decodeMWR3(bytes);
    default: throw new Error('not a MIC file (magic ' + m + ')');
  }
}

return {
  // top level
  decodeMicFile,
  // entropy tier
  fseDecompressAuto, readNCount, buildDtable, buildRansDtable,
  ReverseBitReader,
  // pixel tier
  decodeFrame, rleExpand, rleDecompress, predictorInverse,
  temporalDecode, ycocgrInverse,
  // containers
  decodeMIC1, decodePICS, parsePICSHeader, decodePICA,
  decodeMIC2, decodeMIC2Frame, parseMIC2Header, extractMIC2Frame,
  decodeMICR, decodeRGBBlob, decodePlane,
  parseMIC3Header, decodeMIC3Tile, decodeMIC3Level, decodeMIC3Region,
  // device formats
  mictParse, mictDecode, aliasSlotTables, micwDirectInverse,
  micwParse, decodeMICW, decodeMWR3, soaExpand,
  version: '2.0.0',
};

})();

if (typeof module !== 'undefined' && module.exports) {
  module.exports = MICDecoder;
}
