/* PolyBench 4.2 adi (alternating direction implicit), one time step:
 * the column sweep (forward Thomas recurrence along j, then the back
 * substitution) and the row sweep, parallel over the other dimension.
 * The backward substitutions are descending loops in PolyBench; the
 * pluss grammar takes only unit ascending steps, so they are
 * transcribed with REVERSED subscripts (N-1-c1) — same addresses, same
 * order, in-grammar.
 */
#define N 64

double u[N][N];
double v[N][N];
double p[N][N];
double q[N][N];
double a;
double b;
double c;
double d;
double e;
double f;

/* column sweep: v from u */
#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1) {
  v[0][c0] = 1.0;
  p[c0][0] = 0.0;
  q[c0][0] = v[0][c0];
  for (c1 = 1; c1 <= N - 2; c1 += 1) {
    p[c0][c1] = 0.0 - c / (a * p[c0][c1 - 1] + b);
    q[c0][c1] = (0.0 - d * u[c1][c0 - 1] + (1.0 + 2.0 * d) * u[c1][c0]
                 - f * u[c1][c0 + 1] - a * q[c0][c1 - 1])
                / (a * p[c0][c1 - 1] + b);
  }
  v[N - 1][c0] = 1.0;
  for (c1 = 1; c1 <= N - 2; c1 += 1)
    v[N - 1 - c1][c0] = p[c0][N - 1 - c1] * v[N - c1][c0]
                        + q[c0][N - 1 - c1];
}

/* row sweep: u from v */
#pragma pluss parallel
for (c0 = 1; c0 <= N - 2; c0 += 1) {
  u[c0][0] = 1.0;
  p[c0][0] = 0.0;
  q[c0][0] = u[c0][0];
  for (c1 = 1; c1 <= N - 2; c1 += 1) {
    p[c0][c1] = 0.0 - f / (d * p[c0][c1 - 1] + e);
    q[c0][c1] = (0.0 - a * v[c0 - 1][c1] + (1.0 + 2.0 * a) * v[c0][c1]
                 - c * v[c0 + 1][c1] - d * q[c0][c1 - 1])
                / (d * p[c0][c1 - 1] + e);
  }
  u[c0][N - 1] = 1.0;
  for (c1 = 1; c1 <= N - 2; c1 += 1)
    u[c0][N - 1 - c1] = p[c0][N - 1 - c1] * u[c0][N - c1]
                        + q[c0][N - 1 - c1];
}
