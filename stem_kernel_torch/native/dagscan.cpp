// Native structure-DAG topology builder.
//
// The port's copy of stem_kernel_tpu/native/dagscan.cpp, arithmetic
// unchanged: the C++ counterpart of the candidate-pair scan + DFS node
// emission of stem_kernel_torch/models/dag.py:_dag_topology_python
// (semantics of DAGBuilder::initialize / build_helper,
// stem_kernel/stem_kernel_lite/data.cpp:163-258): given the
// thresholded base-pair matrix over alignment columns, emit nodes (leaf /
// loop / stem) in topological child-first order with CSR edge lists.
//
// Profile quantities (bp_freq, weights) stay in vectorized NumPy — this
// covers the irregular list-heavy part that is slow in Python.

#include <cstddef>
#include <cstdint>
#include <list>
#include <map>
#include <utility>
#include <vector>

using std::size_t;

namespace {

using Pos = std::pair<int, int>;

struct Builder {
    int L;
    const double* bpp;  // L*L row-major
    double th;
    std::map<Pos, std::vector<Pos>> bp_children;
    std::vector<std::vector<Pos>> head;
    std::map<Pos, int> visited;

    // outputs
    std::vector<int> first, last;
    std::vector<int> edge_to, edge_gaps;
    std::vector<int> edge_ptr{0};

    double P(int i, int j) const { return bpp[(int64_t)i * L + j]; }

    void scan() {
        head.assign(L, {});
        std::map<Pos, std::vector<Pos>> ch;
        for (int j = 1; j < L; ++j) {
            for (int i = j - 1; i >= 0; --i) {
                if (P(i, j) >= th) {
                    auto it = ch.find({i + 1, j - 1});
                    if (it != ch.end()) {
                        bp_children[{i, j}] = std::move(it->second);
                        ch.erase(it);
                    } else {
                        bp_children[{i, j}] = {};
                    }
                    ch[{i, j}].push_back({i, j});
                    head[i].push_back({i, j});
                } else {
                    std::vector<Pos> lst;
                    auto it = ch.find({i + 1, j});
                    if (it != ch.end()) {
                        if (!head[i].empty()) {
                            int widest_end = head[i].back().second;
                            for (const auto& x : it->second)
                                if (x.second >= widest_end) lst.push_back(x);
                        } else {
                            lst = it->second;
                        }
                    }
                    for (const auto& h : head[i]) lst.push_back(h);
                    ch[{i, j}] = std::move(lst);
                }
            }
        }
    }

    int emit(Pos pos) {
        auto vit = visited.find(pos);
        if (vit != visited.end()) return vit->second;
        int i = pos.first, j = pos.second;
        std::vector<std::pair<int, int>> kids;  // (node, gaps)
        if (i == j) {
            // leaf
        } else {
            auto it = bp_children.find(pos);
            if (it == bp_children.end() || it->second.empty()) {
                int child = emit({i, i});
                kids.push_back({child, j - i - 1});
            } else {
                for (const auto& c : it->second) {
                    int k = emit(c);
                    kids.push_back({k, (c.first - i - 1) + (j - c.second - 1)});
                }
            }
        }
        first.push_back(i);
        last.push_back(j);
        for (auto& kv : kids) {
            edge_to.push_back(kv.first);
            edge_gaps.push_back(kv.second);
        }
        edge_ptr.push_back((int)edge_to.size());
        int id = (int)first.size() - 1;
        visited[pos] = id;
        return id;
    }

    void build() {
        scan();
        for (int i = 0; i < L; ++i) {
            for (auto it = head[i].rbegin(); it != head[i].rend(); ++it) emit(*it);
        }
        if (first.empty()) emit({0, 0});
    }
};

}  // namespace

// Two-phase API: build once, query sizes, then copy out.
extern "C" void* dag_build(const double* bpp, int L, double th) {
    auto* b = new Builder{L, bpp, th};
    b->build();
    return b;
}

extern "C" void dag_sizes(void* h, int* n_nodes, int* n_edges) {
    auto* b = static_cast<Builder*>(h);
    *n_nodes = (int)b->first.size();
    *n_edges = (int)b->edge_to.size();
}

extern "C" void dag_copy(void* h, int* first, int* last, int* edge_to,
                         int* edge_gaps, int* edge_ptr) {
    auto* b = static_cast<Builder*>(h);
    for (size_t i = 0; i < b->first.size(); ++i) {
        first[i] = b->first[i];
        last[i] = b->last[i];
    }
    for (size_t i = 0; i < b->edge_to.size(); ++i) {
        edge_to[i] = b->edge_to[i];
        edge_gaps[i] = b->edge_gaps[i];
    }
    for (size_t i = 0; i < b->edge_ptr.size(); ++i) edge_ptr[i] = b->edge_ptr[i];
}

extern "C" void dag_free(void* h) { delete static_cast<Builder*>(h); }
