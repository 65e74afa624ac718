/* PolyBench 4.2 jacobi-1d: TSTEPS alternating 3-point sweeps A->B then
 * B->A.  The sequential time loop is unrolled into back-to-back
 * parallel nests (the registry's jacobi2d/fdtd2d convention — nests
 * execute sequentially, per-thread LAT state persists across them).
 */
#define N 256

double A[N];
double B[N];

/* t = 0 */
#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1)
  B[c0] = 0.33333 * (A[c0 - 1] + A[c0] + A[c0 + 1]);

#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1)
  A[c0] = 0.33333 * (B[c0 - 1] + B[c0] + B[c0 + 1]);

/* t = 1 */
#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1)
  B[c0] = 0.33333 * (A[c0 - 1] + A[c0] + A[c0 + 1]);

#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1)
  A[c0] = 0.33333 * (B[c0 - 1] + B[c0] + B[c0 + 1]);
