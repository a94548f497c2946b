// Stage profiler for the native encode pipeline.
// Build:  g++ -O3 -march=native -std=c++17 -pthread -DMIC_PROF_MAIN \
//             -o /tmp/prof_encode prof_encode.cpp
// Run:    /tmp/prof_encode <raw_u16_file> <width> <height> [reps]
// Times each stage of mic_compress_frame separately on real image data.
#include "micfse.cpp"

#include <chrono>
#include <cstdio>
#include <fstream>

using Clock = std::chrono::steady_clock;
static double secs(Clock::time_point a, Clock::time_point b) {
  return std::chrono::duration<double>(b - a).count();
}

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s raw.u16 w h [reps]\n", argv[0]);
    return 2;
  }
  int w = atoi(argv[2]), h = atoi(argv[3]);
  int reps = argc > 4 ? atoi(argv[4]) : 20;
  std::ifstream f(argv[1], std::ios::binary);
  std::vector<uint16_t> px((size_t)w * h);
  f.read((char*)px.data(), px.size() * 2);
  if (!f) { fprintf(stderr, "short read\n"); return 2; }
  uint16_t mx = 0;
  for (auto v : px) mx = v > mx ? v : mx;
  double mb = px.size() * 2.0 / 1e6;
  printf("image %dx%d max=%u (%.2f MB) reps=%d\n", w, h, mx, mb, reps);

  // Stage 1: predictor forward
  std::vector<uint16_t> tokens;
  auto t0 = Clock::now();
  for (int r = 0; r < reps; r++)
    predictor_forward(px.data(), w, h, mx, PRED_AVG, tokens);
  auto t1 = Clock::now();
  printf("predictor_forward: %7.1f MB/s  (%zu tokens)\n",
         mb * reps / secs(t0, t1), tokens.size());

  // Stage 2: RLE encode
  int depth = mx ? high_bit(mx) + 1 : 1;
  uint16_t delim = (uint16_t)((1u << depth) - 1);
  Rle rle;
  t0 = Clock::now();
  for (int r = 0; r < reps; r++) {
    rle.init(delim, tokens.size());
    rle.compress(tokens.data(), tokens.size());
  }
  t1 = Clock::now();
  printf("rle_encode:        %7.1f MB/s  (%zu words)\n",
         mb * reps / secs(t0, t1), rle.size());

  const uint16_t* syms = rle.data();
  size_t n = rle.size();

  // Stage 3: histogram (incl. the per-call counts alloc)
  Norm nm;
  uint32_t maxc = 0;
  t0 = Clock::now();
  for (int r = 0; r < reps; r++) {
    std::vector<uint32_t> counts(kMaxSymbol + 1, 0);
    maxc = 0;
    int sl = 0;
    for (size_t i = 0; i < n; i++) {
      uint32_t c = ++counts[syms[i]];
      if (c > maxc) maxc = c;
      if ((int)syms[i] + 1 > sl) sl = syms[i] + 1;
    }
    nm.symbol_len = sl;
  }
  t1 = Clock::now();
  printf("histogram:         %7.1f MB/s  (sl=%d maxc=%u)\n",
         mb * reps / secs(t0, t1), nm.symbol_len, maxc);

  // Stage 4: normalize + write_count + build_ctable
  {
    std::vector<uint32_t> counts(kMaxSymbol + 1, 0);
    for (size_t i = 0; i < n; i++) counts[syms[i]]++;
    nm.table_log = optimal_table_log(11, (int64_t)n, nm.symbol_len);
    t0 = Clock::now();
    for (int r = 0; r < reps; r++) {
      normalize(counts.data(), (int64_t)n, nm);
      std::vector<uint8_t> hdr;
      write_count(nm, hdr);
      CTable ct;
      std::vector<uint16_t> tbl;
      std::vector<uint32_t> cumul;
      build_ctable(nm, ct, tbl, cumul);
    }
    t1 = Clock::now();
    printf("norm+hdr+ctable:   %7.1f MB/s  (tl=%d)\n",
           mb * reps / secs(t0, t1), nm.table_log);
  }

  // Stage 5: fse_encode_bits (4-state)
  std::vector<uint8_t> bits;
  t0 = Clock::now();
  for (int r = 0; r < reps; r++) fse_encode_bits(syms, n, nm, 4, bits);
  t1 = Clock::now();
  printf("fse_encode_bits:   %7.1f MB/s  (%zu bytes)\n",
         mb * reps / secs(t0, t1), bits.size());

  // End-to-end
  std::vector<uint8_t> blob(px.size() * 2 + 1024);
  size_t bl = 0;
  t0 = Clock::now();
  for (int r = 0; r < reps; r++)
    bl = mic_compress_frame(px.data(), w, h, mx, 0, 4, blob.data(), blob.size());
  t1 = Clock::now();
  printf("mic_compress_frame:%7.1f MB/s  (%zu bytes, ratio %.3f)\n",
         mb * reps / secs(t0, t1), bl, px.size() * 2.0 / bl);
  return bl ? 0 : 1;
}
