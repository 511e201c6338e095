// tinyrt: native host-side runtime of tinyraytracer_tpu_torch, the port's
// own copy of tinyraytracer_tpu/native/src/tinyrt.cpp with the same C entry
// points. It is a host library, not a GPU kernel: the two host-side hot
// paths of the renderer.
//
//   tinyrt_bvh_build : threaded (hit-link/miss-link) BVH flattening.
//                      Policy is bit-identical to ops/bvh.py::_build_host
//                      (and to the reference bvh.rs:42-84): median split
//                      on the longest axis of the node bbox, members
//                      stable-sorted by bbox min on that axis, n==2 skips
//                      the sort, 1 prim/leaf, DFS preorder with the left
//                      subtree first.
//   tinyrt_write_png : minimal RGB8 PNG encoder (zlib for deflate + crc32),
//                      the analog of the reference's `image` crate encode
//                      (utils/image.rs:66-69).
//
// Built with g++ at first use and loaded with ctypes (native/runtime.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build
// ---------------------------------------------------------------------------

int tinyrt_bvh_build(const float* bb_min, const float* bb_max, int n,
                     float* node_min, float* node_max, int* hit_link,
                     int* miss_link, int* leaf_prim) {
  if (n <= 0) return 1;
  const int m = 2 * n - 1;
  for (int i = 0; i < m; ++i) leaf_prim[i] = -1;

  struct Task {
    std::vector<int> members;
    int escape;
  };
  std::vector<Task> stack;
  {
    std::vector<int> all(n);
    for (int i = 0; i < n; ++i) all[i] = i;
    stack.push_back({std::move(all), m});
  }

  int next_idx = 0;
  while (!stack.empty()) {
    Task task = std::move(stack.back());
    stack.pop_back();
    const int idx = next_idx++;
    if (idx >= m) return 2;  // internal inconsistency

    float mn[3] = {3.0e38f, 3.0e38f, 3.0e38f};
    float mx[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
    for (int p : task.members) {
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bb_min[3 * p + a]);
        mx[a] = std::max(mx[a], bb_max[3 * p + a]);
      }
    }
    std::memcpy(node_min + 3 * idx, mn, sizeof(mn));
    std::memcpy(node_max + 3 * idx, mx, sizeof(mx));
    miss_link[idx] = task.escape;

    const size_t k = task.members.size();
    if (k == 1) {
      leaf_prim[idx] = task.members[0];
      hit_link[idx] = task.escape;  // unused for leaves; keep well-defined
      continue;
    }
    hit_link[idx] = idx + 1;

    // Longest axis of the node bbox (aabb.rs:63-78). Tie rule matches the
    // reference exactly: equal extents resolve to z (its if/else chain
    // requires a strictly greater extent to pick x or y).
    const float ex = mx[0] - mn[0];
    const float ey = mx[1] - mn[1];
    const float ez = mx[2] - mn[2];
    int axis;
    if (ex > ey) {
      axis = (ex > ez) ? 0 : 2;
    } else {
      axis = (ey > ez) ? 1 : 2;
    }

    std::vector<int> left, right;
    if (k == 2) {  // bvh.rs:58-67: no sort for two members
      left.assign(task.members.begin(), task.members.begin() + 1);
      right.assign(task.members.begin() + 1, task.members.end());
    } else {
      std::stable_sort(task.members.begin(), task.members.end(),
                       [&](int a, int b) {
                         return bb_min[3 * a + axis] < bb_min[3 * b + axis];
                       });
      const size_t half = k / 2;
      left.assign(task.members.begin(), task.members.begin() + half);
      right.assign(task.members.begin() + half, task.members.end());
    }
    // DFS preorder: left occupies idx+1 .. idx+2*|left|-1, then right.
    const int right_start = idx + 1 + (2 * static_cast<int>(left.size()) - 1);
    stack.push_back({std::move(right), task.escape});
    stack.push_back({std::move(left), right_start});
  }
  return next_idx == m ? 0 : 3;
}

// ---------------------------------------------------------------------------
// PNG encode (RGB8, color type 2, bit depth 8, filter 0)
// ---------------------------------------------------------------------------

static void put_be32(std::vector<unsigned char>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

static void put_chunk(std::vector<unsigned char>& out, const char tag[4],
                      const unsigned char* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  const size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + tag_pos, static_cast<uInt>(4 + len));
  put_be32(out, crc);
}

int tinyrt_write_png(const char* path, const unsigned char* rgb, int width,
                     int height) {
  if (width <= 0 || height <= 0 || !rgb || !path) return 1;

  // Raw stream: one filter byte (0 = None) per scanline + RGB pixels.
  const size_t stride = static_cast<size_t>(width) * 3;
  std::vector<unsigned char> raw((stride + 1) * height);
  for (int y = 0; y < height; ++y) {
    unsigned char* row = raw.data() + y * (stride + 1);
    row[0] = 0;
    std::memcpy(row + 1, rgb + y * stride, stride);
  }

  uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<unsigned char> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(),
                static_cast<uLong>(raw.size()), 6) != Z_OK)
    return 2;
  comp.resize(comp_cap);

  std::vector<unsigned char> out;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);

  unsigned char ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  put_chunk(out, "IHDR", ihdr, sizeof(ihdr));
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 3;
  const size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return wrote == out.size() ? 0 : 4;
}

}  // extern "C"
