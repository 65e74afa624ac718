/* PolyBench 4.2 deriche (edge-detection filter): horizontal forward +
 * backward IIR scans into y1/y2, combine into imgOut, then the vertical
 * pair.  The recurrence state (xm1, ym1, ym2, ...) lives in scalars —
 * registers, not walked — exactly as PolyBench writes it; the backward
 * scans are descending in PolyBench and are transcribed here with
 * reversed subscripts (H-1-c1 / W-1-c1) to stay in the unit-ascending
 * grammar.
 */
#define W 64
#define H 64

double imgIn[W][H];
double imgOut[W][H];
double y1[W][H];
double y2[W][H];
double xm1;
double tm1;
double ym1;
double ym2;
double xp1;
double xp2;
double tp1;
double tp2;
double yp1;
double yp2;
double a1;
double a2;
double a3;
double a4;
double a5;
double a6;
double a7;
double a8;
double b1;
double b2;
double c1;
double c2;

/* horizontal forward scan */
#pragma pluss parallel
for (c0 = 0; c0 <= W - 1; c0 += 1)
  for (c5 = 0; c5 <= H - 1; c5 += 1) {
    y1[c0][c5] = a1 * imgIn[c0][c5] + a2 * xm1 + b1 * ym1 + b2 * ym2;
    xm1 = imgIn[c0][c5];
    ym2 = ym1;
    ym1 = y1[c0][c5];
  }

/* horizontal backward scan (reversed subscripts) */
#pragma pluss parallel
for (c0 = 0; c0 <= W - 1; c0 += 1)
  for (c5 = 0; c5 <= H - 1; c5 += 1) {
    y2[c0][H - 1 - c5] = a3 * xp1 + a4 * xp2 + b1 * yp1 + b2 * yp2;
    xp2 = xp1;
    xp1 = imgIn[c0][H - 1 - c5];
    yp2 = yp1;
    yp1 = y2[c0][H - 1 - c5];
  }

/* horizontal combine */
#pragma pluss parallel
for (c0 = 0; c0 <= W - 1; c0 += 1)
  for (c5 = 0; c5 <= H - 1; c5 += 1)
    imgOut[c0][c5] = c1 * (y1[c0][c5] + y2[c0][c5]);

/* vertical forward scan (parallel over columns) */
#pragma pluss parallel
for (c0 = 0; c0 <= H - 1; c0 += 1)
  for (c5 = 0; c5 <= W - 1; c5 += 1) {
    y1[c5][c0] = a5 * imgOut[c5][c0] + a6 * tm1 + b1 * ym1 + b2 * ym2;
    tm1 = imgOut[c5][c0];
    ym2 = ym1;
    ym1 = y1[c5][c0];
  }

/* vertical backward scan (reversed subscripts) */
#pragma pluss parallel
for (c0 = 0; c0 <= H - 1; c0 += 1)
  for (c5 = 0; c5 <= W - 1; c5 += 1) {
    y2[W - 1 - c5][c0] = a7 * tp1 + a8 * tp2 + b1 * yp1 + b2 * yp2;
    tp2 = tp1;
    tp1 = imgOut[W - 1 - c5][c0];
    yp2 = yp1;
    yp1 = y2[W - 1 - c5][c0];
  }

/* vertical combine */
#pragma pluss parallel
for (c0 = 0; c0 <= H - 1; c0 += 1)
  for (c5 = 0; c5 <= W - 1; c5 += 1)
    imgOut[c5][c0] = c2 * (y1[c5][c0] + y2[c5][c0]);
