// Single-cluster line mapper of the trace feed (host code, not a kernel).
//
// The port's copy of pluss_map_lines (pluss/cpp/capi.cpp), behind
// pluss_torch/trace.py's _Compactor.map_raw: little-endian u64 byte
// addresses -> dense int32 line ids in one branchless pass, where the
// numpy route (shift, min/max containment check, subtract, narrowing cast)
// takes four or more passes over the batch.  Built with the host compiler
// by pluss_torch/ops/build.py and called through ctypes, which releases
// the interpreter lock, so the feed pool's workers overlap it with their
// reads and encodes.
//
// Returns 1 when every line falls inside [start, start + width); else 0,
// and the caller maps the chunk with the general cluster probe (which
// also discovers new clusters).

extern "C" int pluss_torch_map_lines(const unsigned long long* raw,
                                     long long n, int shift, long long start,
                                     long long width, long long base,
                                     int* out) {
  long long ok = 1;
  long long rebase = base - start;
  for (long long i = 0; i < n; ++i) {
    // arithmetic shift of the SIGNED value: trace.lines_of shifts int64,
    // so an address with bit 63 set must map identically here
    long long line = static_cast<long long>(raw[i]) >> shift;
    long long off = line - start;
    ok &= static_cast<long long>(off >= 0) &
          static_cast<long long>(off < width);
    out[i] = static_cast<int>(line + rebase);
  }
  return static_cast<int>(ok);
}
