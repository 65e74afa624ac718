/* gemm.ppcg_omp.c-shaped source: the kernel the reference's generated
 * GEMM sampler was derived from (C = beta*C + alpha*A*B at N = 128 —
 * the reference's c_lib/test/gemm.ppcg_omp.c:72-98).  `cli import
 * <this file> --run --check-model gemm` must print a histogram + MRC
 * byte-identical to the registry `gemm` model's (tests/test_torch_
 * frontend.py and chip_smoke.py's `frontend` phase pin it).
 */
#define N 128

double C[N][N];
double A[N][N];
double B[N][N];
double alpha;
double beta;

#pragma pluss parallel
for (c0 = 0; c0 <= N - 1; c0 += 1)
  for (c1 = 0; c1 <= N - 1; c1 += 1) {
    C[c0][c1] *= beta;
    for (c2 = 0; c2 <= N - 1; c2 += 1)
      C[c0][c1] += alpha * A[c0][c2] * B[c2][c1];
  }
