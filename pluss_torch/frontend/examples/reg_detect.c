/* PolyBench 3.x reg_detect (regularity-detection medley), one niter
 * iteration: the triangular i >= j sweeps over diff/sum_diff/mean and
 * the diagonal path accumulation.  Parallel over j; the i loops are
 * lower-triangular (`i = c0 .. MAXGRID-1`), which lowers to the spec's
 * varying-start + varying-trip form (start_coef=1, bound_coef=(MAXGRID,
 * -1)) — the covariance shape.
 */
#define MAXGRID 32
#define LENGTH 16

double sum_tang[MAXGRID][MAXGRID];
double mean[MAXGRID][MAXGRID];
double diff[MAXGRID][MAXGRID][LENGTH];
double sum_diff[MAXGRID][MAXGRID][LENGTH];
double path[MAXGRID][MAXGRID];

#pragma pluss parallel
for (c0 = 0; c0 <= MAXGRID - 1; c0 += 1)
  for (c1 = c0; c1 <= MAXGRID - 1; c1 += 1)
    for (c2 = 0; c2 <= LENGTH - 1; c2 += 1)
      diff[c0][c1][c2] = sum_tang[c0][c1];

#pragma pluss parallel
for (c0 = 0; c0 <= MAXGRID - 1; c0 += 1)
  for (c1 = c0; c1 <= MAXGRID - 1; c1 += 1) {
    sum_diff[c0][c1][0] = diff[c0][c1][0];
    for (c2 = 1; c2 <= LENGTH - 1; c2 += 1)
      sum_diff[c0][c1][c2] = sum_diff[c0][c1][c2 - 1] + diff[c0][c1][c2];
    mean[c0][c1] = sum_diff[c0][c1][LENGTH - 1];
  }

#pragma pluss parallel
for (c0 = 0; c0 <= MAXGRID - 1; c0 += 1)
  path[0][c0] = mean[0][c0];

#pragma pluss parallel
for (c0 = 1; c0 <= MAXGRID - 1; c0 += 1)
  for (c1 = c0; c1 <= MAXGRID - 1; c1 += 1)
    path[c0][c1] = path[c0 - 1][c1 - 1] + mean[c0][c1];
