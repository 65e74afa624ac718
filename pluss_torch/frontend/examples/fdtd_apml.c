/* PolyBench 3.x fdtd-apml (FDTD with anisotropic perfectly-matched
 * layers): the Hz update over (iz, iy, ix) with its per-axis PML
 * coefficient vectors, plus the iy-boundary tail statement — parallel
 * over iz planes.  Scalars (clf, tmp, ch, mui) are registers; the
 * coefficient divisions are value arithmetic the sampler does not walk,
 * so they stay as written.
 */
#define CZ 16
#define CYM 16
#define CXM 16

double Ex[CZ][CYM + 1][CXM + 1];
double Ey[CZ][CYM + 1][CXM + 1];
double Hz[CZ][CYM][CXM];
double Bza[CZ][CYM][CXM];
double czm[CZ];
double czp[CZ];
double cxmh[CXM + 1];
double cxph[CXM + 1];
double cymh[CYM + 1];
double cyph[CYM + 1];
double clf;
double tmp;
double ch;
double mui;

#pragma pluss parallel
for (c0 = 0; c0 <= CZ - 1; c0 += 1)
  for (c1 = 0; c1 <= CYM - 1; c1 += 1) {
    for (c2 = 0; c2 <= CXM - 1; c2 += 1) {
      clf = Ex[c0][c1][c2] - Ex[c0][c1 + 1][c2]
            + Ey[c0][c1][c2 + 1] - Ey[c0][c1][c2];
      tmp = (cymh[c1] / cyph[c1]) * Bza[c0][c1][c2]
            - (ch / cyph[c1]) * clf;
      Hz[c0][c1][c2] = (cxmh[c2] / cxph[c2]) * Hz[c0][c1][c2]
                       + (mui * czp[c0] / cxph[c2]) * tmp
                       - (mui * czm[c0] / cxph[c2]) * Bza[c0][c1][c2];
      Bza[c0][c1][c2] = tmp;
    }
    clf = Ex[c0][c1][CXM - 1] - Ex[c0][c1 + 1][CXM - 1]
          + Ey[c0][c1][CXM] - Ey[c0][c1][CXM - 1];
    tmp = (cymh[c1] / cyph[c1]) * Bza[c0][c1][CXM - 1]
          - (ch / cyph[c1]) * clf;
    Hz[c0][c1][CXM - 1] = (cxmh[CXM - 1] / cxph[CXM - 1])
                          * Hz[c0][c1][CXM - 1]
                          + (mui * czp[c0] / cxph[CXM - 1]) * tmp
                          - (mui * czm[c0] / cxph[CXM - 1])
                          * Bza[c0][c1][CXM - 1];
    Bza[c0][c1][CXM - 1] = tmp;
  }
