// Union-find (disjoint-set) connected components over an edge list.
//
// Native runtime component for multiview track building: the reference
// builds tracks from pairwise matches with pandas chain resolution
// (io/h5_to_bundler.py:517-810) which is quadratic-ish and slow at scale;
// this is a path-halving + union-by-size DSU, O(E α(N)), callable from
// Python via ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC unionfind.cpp -o libunionfind.so

#include <cstdint>
#include <vector>

extern "C" {

// edges: 2*n_edges int64 (u0, v0, u1, v1, ...); out_root: n_nodes int64.
// Returns the number of distinct components.
int64_t uf_components(int64_t n_nodes, const int64_t* edges, int64_t n_edges,
                      int64_t* out_root) {
    std::vector<int64_t> parent(n_nodes);
    std::vector<int64_t> size(n_nodes, 1);
    for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

    auto find = [&](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];  // path halving
            x = parent[x];
        }
        return x;
    };

    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = find(edges[2 * e]);
        int64_t b = find(edges[2 * e + 1]);
        if (a == b) continue;
        if (size[a] < size[b]) { int64_t t = a; a = b; b = t; }
        parent[b] = a;
        size[a] += size[b];
    }

    int64_t n_comp = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        out_root[i] = find(i);
        if (out_root[i] == i) ++n_comp;
    }
    return n_comp;
}

}  // extern "C"
