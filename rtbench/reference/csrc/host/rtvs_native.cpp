// Host BVH builder of raytracevs_tpu_torch: the binned-SAH threaded BVH of
// the JAX package's csrc/rtvs_native.cpp (rtvs_build_bvh), copied so the
// port builds the very same tree. The reference has D3D12 build its
// triangle BLAS (AccelerationStructure.cpp:560-663); here the
// host builds it with a binned-SAH sweep and emits flat threaded (skip-link)
// arrays in DFS preorder, which the plain walks follow (ops/bvh.py).
// rtvs_collapse_bvh turns such a tree into the 4-wide nodes that the
// kernels' walks read (csrc/closest.cuh), once per BLAS.
//
// Built by g++ at first use (io/native.py) with the flags of the JAX
// package's csrc/Makefile, and loaded with ctypes through a plain C ABI.
// The pre-split reference builder and the FNV checksum of that file are
// left out: the port reads no RTVS_PRESPLIT flag and hashes scenes in numpy.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{1e30f, 1e30f, 1e30f};
    Vec3 hi{-1e30f, -1e30f, -1e30f};
    void grow(const AABB& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
    Vec3 centroid() const {
        return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
    }
};

struct BuildNode {
    AABB bounds;
    int left = -1;   // child node index (internal) or -1
    int right = -1;
    int start = 0;   // leaf triangle range in `order`
    int count = 0;
};

struct Builder {
    const AABB* tri_bounds;
    std::vector<int> order;
    std::vector<BuildNode> nodes;
    int leaf_size;

    static constexpr int kBins = 16;

    int build(int begin, int end) {
        int me = (int)nodes.size();
        nodes.emplace_back();
        AABB bounds, cbounds;
        for (int i = begin; i < end; ++i) {
            bounds.grow(tri_bounds[order[i]]);
            cbounds.grow(tri_bounds[order[i]].centroid());
        }
        nodes[me].bounds = bounds;
        int n = end - begin;
        if (n <= leaf_size) {
            nodes[me].start = begin;
            nodes[me].count = n;
            return me;
        }

        // Binned SAH over the widest centroid axis.
        Vec3 ext = {cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                    cbounds.hi.z - cbounds.lo.z};
        int axis = 0;
        float w = ext.x;
        if (ext.y > w) { axis = 1; w = ext.y; }
        if (ext.z > w) { axis = 2; w = ext.z; }
        float lo = axis == 0 ? cbounds.lo.x : (axis == 1 ? cbounds.lo.y : cbounds.lo.z);
        if (w < 1e-12f) {
            // Degenerate spread: median split.
            int mid = begin + n / 2;
            int l = build(begin, mid);
            int r = build(mid, end);
            nodes[me].left = l;
            nodes[me].right = r;
            return me;
        }

        AABB bin_bounds[kBins];
        int bin_count[kBins] = {0};
        float inv = kBins / w;
        auto bin_of = [&](int tri) {
            Vec3 c = tri_bounds[tri].centroid();
            float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
            int b = (int)((v - lo) * inv);
            return std::min(std::max(b, 0), kBins - 1);
        };
        for (int i = begin; i < end; ++i) {
            int b = bin_of(order[i]);
            bin_bounds[b].grow(tri_bounds[order[i]]);
            bin_count[b]++;
        }

        // Sweep for the best split plane.
        AABB right_acc[kBins];
        AABB acc;
        for (int b = kBins - 1; b >= 1; --b) {
            acc.grow(bin_bounds[b]);
            right_acc[b] = acc;
        }
        float best_cost = 1e30f;
        int best_split = -1;
        AABB lacc;
        int lcount = 0;
        for (int b = 0; b < kBins - 1; ++b) {
            lacc.grow(bin_bounds[b]);
            lcount += bin_count[b];
            int rcount = n - lcount;
            if (lcount == 0 || rcount == 0) continue;
            float cost = lacc.area() * lcount + right_acc[b + 1].area() * rcount;
            if (cost < best_cost) {
                best_cost = cost;
                best_split = b;
            }
        }

        int mid;
        if (best_split < 0 || best_cost >= bounds.area() * n) {
            mid = begin + n / 2;
            std::nth_element(
                order.begin() + begin, order.begin() + mid, order.begin() + end,
                [&](int a, int b2) {
                    Vec3 ca = tri_bounds[a].centroid();
                    Vec3 cb = tri_bounds[b2].centroid();
                    float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                    float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                    return va < vb;
                });
        } else {
            auto it = std::partition(order.begin() + begin, order.begin() + end,
                                     [&](int t) { return bin_of(t) <= best_split; });
            mid = (int)(it - order.begin());
            if (mid == begin || mid == end) mid = begin + n / 2;
        }

        int l = build(begin, mid);
        int r = build(mid, end);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

// Iterative threading (skip links) to avoid deep recursion on host stacks.
void thread_bvh(const std::vector<BuildNode>& nodes, int root, int* hit_next,
                int* miss_next, int* tri_start, int* tri_count, float* bbox_min,
                float* bbox_max) {
    std::vector<std::pair<int, int>> stack;  // (node, miss)
    stack.emplace_back(root, -1);
    while (!stack.empty()) {
        auto [node, miss] = stack.back();
        stack.pop_back();
        const BuildNode& bn = nodes[node];
        bbox_min[node * 3 + 0] = bn.bounds.lo.x;
        bbox_min[node * 3 + 1] = bn.bounds.lo.y;
        bbox_min[node * 3 + 2] = bn.bounds.lo.z;
        bbox_max[node * 3 + 0] = bn.bounds.hi.x;
        bbox_max[node * 3 + 1] = bn.bounds.hi.y;
        bbox_max[node * 3 + 2] = bn.bounds.hi.z;
        miss_next[node] = miss;
        if (bn.left < 0) {
            tri_start[node] = bn.start;
            tri_count[node] = bn.count;
            hit_next[node] = miss;
        } else {
            tri_start[node] = 0;
            tri_count[node] = 0;
            hit_next[node] = bn.left;
            // push right first so left is processed next (preorder)
            stack.emplace_back(bn.right, miss);
            stack.emplace_back(bn.left, bn.right);
        }
    }
}

}  // namespace

extern "C" {

// Build a threaded BVH. Outputs are caller-allocated with capacity
// 2*num_tris nodes. Returns the node count (or -1 on error).
int rtvs_build_bvh(const float* v0, const float* v1, const float* v2,
                   int num_tris, int leaf_size, float* bbox_min, float* bbox_max,
                   int* hit_next, int* miss_next, int* tri_start, int* tri_count,
                   int* tri_order) {
    if (num_tris <= 0 || leaf_size <= 0) return -1;
    std::vector<AABB> tb((size_t)num_tris);
    for (int i = 0; i < num_tris; ++i) {
        Vec3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
        Vec3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
        Vec3 c{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
        tb[i].grow(a);
        tb[i].grow(b);
        tb[i].grow(c);
    }
    Builder builder;
    builder.tri_bounds = tb.data();
    builder.leaf_size = leaf_size;
    builder.order.resize((size_t)num_tris);
    for (int i = 0; i < num_tris; ++i) builder.order[i] = i;
    builder.nodes.reserve((size_t)num_tris * 2);
    int root = builder.build(0, num_tris);
    // The recursive build emits preorder already (node appended before
    // children), so `root` is 0 and indices are final.
    (void)root;
    thread_bvh(builder.nodes, 0, hit_next, miss_next, tri_start, tri_count,
               bbox_min, bbox_max);
    std::memcpy(tri_order, builder.order.data(), sizeof(int) * (size_t)num_tris);
    return (int)builder.nodes.size();
}

// The wide nodes of the threaded tree (or chained forest) whose root is
// fine node `root`, topology only (ops/bvh.py::collapse). Each wide node
// holds its fine node's two children, then opens the inner child with the
// most triangles (the leftmost on ties) in place until it has `wide`
// children or only leaves; a leaf root is a wide node of one leaf. Wide
// node 0 is the root and a node's inner children get the next indices when
// it is written, in the order of a preorder walk. Writes per wide node
// `wide` child words (a wide node index >= 0, a leaf ~(tri_start << 3 |
// tri_count), or -1 for an empty slot) and `wide` fine nodes (-1: empty),
// and into *need the deepest stack a walk needs: over root-to-leaf paths,
// the sum of (children - 1) of the wide nodes on the path. The outputs
// hold num_nodes wide nodes. Returns the wide node count, or -1 on error.
int rtvs_collapse_bvh(const int* tri_start, const int* tri_count, const int* miss_next,
                      int num_nodes, int root, int wide, int* child, int* src, int* need) {
    if (num_nodes <= 0 || root < 0 || root >= num_nodes || wide < 2 || wide > 8) return -1;
    const int n = num_nodes;
    // a node's subtree is [f, end[f]) in preorder: its miss link, or the end
    std::vector<int> end((size_t)n);
    std::vector<int64_t> tris((size_t)n + 1, 0);
    for (int f = 0; f < n; ++f) {
        end[f] = miss_next[f] >= 0 ? miss_next[f] : n;
        tris[f + 1] = tris[f] + tri_count[f];
    }
    auto leaf = [&](int f) { return tri_count[f] > 0; };
    auto size = [&](int f) { return tris[end[f]] - tris[f]; };
    std::vector<std::vector<int>> inner_of;  // per wide node: its inner children's wide indices
    std::vector<std::pair<int, int>> todo{{root, 0}};  // (fine node, its wide index)
    int count = 1;
    inner_of.emplace_back();
    while (!todo.empty()) {
        auto [f, w] = todo.back();
        todo.pop_back();
        int kids[8], nk = 0;
        if (leaf(f)) {
            kids[nk++] = f;
        } else {
            if (f + 1 >= n || end[f + 1] >= n) return -1;
            kids[nk++] = f + 1;
            kids[nk++] = end[f + 1];
        }
        while (nk < wide) {
            int best = -1;
            for (int i = 0; i < nk; ++i)
                if (!leaf(kids[i]) && (best < 0 || size(kids[i]) > size(kids[best]))) best = i;
            if (best < 0) break;
            int k = kids[best];
            if (k + 1 >= n || end[k + 1] >= n) return -1;
            for (int i = nk; i > best + 1; --i) kids[i] = kids[i - 1];
            kids[best] = k + 1;
            kids[best + 1] = end[k + 1];
            ++nk;
        }
        size_t first = todo.size();
        for (int i = 0; i < wide; ++i) {
            int word = -1, s = -1;
            if (i < nk) {
                int k = kids[i];
                s = k;
                if (leaf(k)) {
                    word = ~(tri_start[k] << 3 | tri_count[k]);
                } else {
                    if (count >= n) return -1;
                    word = count++;
                    inner_of.emplace_back();
                    inner_of[w].push_back(word);
                    todo.emplace_back(k, word);
                }
            }
            child[(size_t)w * wide + i] = word;
            src[(size_t)w * wide + i] = s;
        }
        std::reverse(todo.begin() + (std::ptrdiff_t)first, todo.end());  // first child next
    }
    std::vector<int> depth((size_t)count, 0);
    for (int w = count - 1; w >= 0; --w) {  // children's indices exceed their parent's
        int nk = 0, deepest = 0;
        for (int i = 0; i < wide; ++i) nk += child[(size_t)w * wide + i] != -1;
        for (int c : inner_of[w]) deepest = std::max(deepest, depth[c]);
        depth[w] = nk - 1 + deepest;
    }
    *need = depth[0];
    return count;
}

}  // extern "C"
