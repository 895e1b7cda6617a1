// simcore: native helpers for the host-side simulators (the port's copy of
// the JAX package's native/simcore.cpp; the code below the comments is the
// same, so both libraries render the same bytes).
//
//   raycast_render — the gridworld first-person frame (96 columns x ~80 ray
//       steps x per-step object tests), the inner loop of
//       var_tpu_torch/envs/grid_sim.py::GridHouseSim.get_image
//   rotate_crop    — nearest-neighbor rotated egocentric occupancy crop
//
// Built as a plain C ABI shared object and loaded through ctypes by
// var_tpu_torch/native.py. The numpy raycast (GridHouseSim._render_numpy)
// is the plain version; the two differ at a few boundary pixels where a
// float tie falls the other way (tests/test_torch_native.py bounds it).
//
// Build: g++ -O3 -shared -fPIC simcore.cpp -o libsimcore.so
// (no -march=native and no fast-math: either could contract a*b+c into an
// FMA and move a ray sample, and then the bytes would differ from the JAX
// package's library)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Renders one first-person frame.
//   grid:    rows x cols uint8, nonzero = wall
//   objs:    n_objs x 4 float32 rows [cell_r, cell_c, toggled, type_idx]
//   colors:  n_types x 2 x 3 float32 (off/on RGB per type)
//   pose:    [row, col] (cell coords), rot_deg
//   out:     H x W x 3 uint8
void raycast_render(
    const uint8_t* grid, int rows, int cols,
    const float* objs, int n_objs,
    const float* colors,
    float pos_r, float pos_c, float rot_deg,
    float fov_deg, int H, int W,
    const uint8_t* wall_color, const uint8_t* floor_color,
    const uint8_t* ceil_color,
    uint8_t* out) {
  // sky/floor fill
  for (int r = 0; r < H / 2; ++r)
    for (int c = 0; c < W; ++c)
      memcpy(out + (r * W + c) * 3, ceil_color, 3);
  for (int r = H / 2; r < H; ++r)
    for (int c = 0; c < W; ++c)
      memcpy(out + (r * W + c) * 3, floor_color, 3);

  // double precision throughout, as the numpy (float64) path computes
  const double fov = (double)fov_deg * M_PI / 180.0;
  const double tan_half = tan(fov / 2.0);
  const double max_range = 12.0;
  const double start_r = (double)pos_r + 0.5, start_c = (double)pos_c + 0.5;

  for (int col = 0; col < W; ++col) {
    // match the numpy path: angle = rot + atan(linspace(-tan, tan))
    const double frac = (W == 1) ? 0.0 : (double)col / (double)(W - 1);
    const double off = atan(-tan_half + 2.0 * tan_half * frac);
    const double th = (double)rot_deg * M_PI / 180.0 + off;
    const double dr = cos(th), dc = sin(th);

    int hit_obj = -1;
    double dist = max_range;
    // t = 0.15 * k, matching np.arange(0.15, max_range, 0.15)
    for (int k = 1; ; ++k) {
      const double t = 0.15 * (double)k;
      if (t >= max_range) break;
      const double pr = start_r + dr * t;
      const double pc = start_c + dc * t;
      // int() truncation + integer bounds check, matching the numpy path
      const int r = (int)pr, c = (int)pc;
      if (r < 0 || c < 0 || r >= rows || c >= cols) { dist = t; break; }
      bool matched = false;
      for (int i = 0; i < n_objs; ++i) {
        if ((int)objs[i * 4 + 0] == r && (int)objs[i * 4 + 1] == c) {
          hit_obj = i; dist = t; matched = true; break;
        }
      }
      if (matched) break;
      if (grid[r * cols + c]) { dist = t; break; }
    }

    int hgt = (int)(H / (dist + 0.3));
    if (hgt < 4) hgt = 4;
    if (hgt > H) hgt = H;
    const int top = (H - hgt) / 2;
    double shade = 1.5 / (0.4 + 0.25 * dist);
    if (shade > 1.0) shade = 1.0;
    if (shade < 0.15) shade = 0.15;

    double base[3];
    if (hit_obj >= 0) {
      const int type_idx = (int)objs[hit_obj * 4 + 3];
      const int toggled = objs[hit_obj * 4 + 2] != 0.0f ? 1 : 0;
      const float* cptr = colors + (type_idx * 2 + toggled) * 3;
      base[0] = cptr[0]; base[1] = cptr[1]; base[2] = cptr[2];
    } else {
      base[0] = wall_color[0]; base[1] = wall_color[1]; base[2] = wall_color[2];
    }
    uint8_t px[3];
    for (int k = 0; k < 3; ++k) {
      double v = base[k] * shade;
      if (v > 255.0) v = 255.0;
      if (v < 0.0) v = 0.0;
      px[k] = (uint8_t)v;
    }
    for (int r = top; r < top + hgt; ++r)
      memcpy(out + (r * W + col) * 3, px, 3);
  }
}

// Nearest-neighbor rotation of a square uint8 window about its center
// (counterclockwise like scipy.ndimage.rotate(reshape=False, order=0);
// tie-breaking at half-pixel boundaries may differ from scipy — the
// gridworld sim uses scipy for the tiny 9x9 occupancy crop and this
// routine is provided for bulk host-side use).
void rotate_crop(const uint8_t* in, int n, float angle_deg, uint8_t* out) {
  const float th = angle_deg * (float)M_PI / 180.0f;
  const float ca = cosf(th), sa = -sinf(th);
  const float cy = (n - 1) / 2.0f, cx = (n - 1) / 2.0f;
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < n; ++c) {
      // inverse-rotate output coords into input space
      const float y = r - cy, x = c - cx;
      const float sr = ca * y - sa * x + cy;
      const float sc = sa * y + ca * x + cx;
      const int ir = (int)roundf(sr), ic = (int)roundf(sc);
      out[r * n + c] =
          (ir >= 0 && ir < n && ic >= 0 && ic < n) ? in[ir * n + ic] : 0;
    }
  }
}

}  // extern "C"
