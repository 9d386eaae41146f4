// Native data-pipeline helpers of megatron_tpu_torch (host C++, no CUDA).
//
// The port's copy of the two functions of megatron_tpu/data/helpers.cpp that
// the GPT data path runs: the sequential sample-index walk (taken only when a
// corpus has empty documents) and the greedy blending indices. Same
// algorithms as the reference's pybind11 helpers (ref: megatron/data/
// helpers.cpp build_sample_idx :83-166, build_blending_indices :20-80), as a
// plain extern "C" library bound through ctypes. Built at first use by
// megatron_tpu_torch/data/helpers.py into the repository's build/ directory:
//
//   g++ -O3 -shared -fPIC -o build/libdata_helpers_<hash>.so helpers.cpp

#include <cstdint>

extern "C" {

// Sequential sample-index walk. `sizes`: tokens per sequence in the indexed
// dataset; `doc_idx`: epoch-replicated shuffled document ids; out:
// [num_samples+1, 2] int32 of (doc_idx position, in-doc token offset).
// Mirrors the -1 one-token-overlap bookkeeping of the reference walk.
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int64_t doc_idx_len, int32_t seq_length,
                      int32_t num_epochs, int64_t tokens_per_epoch,
                      int32_t* out /* [(num_samples+1)*2] */) {
    const int64_t num_samples =
        (static_cast<int64_t>(num_epochs) * tokens_per_epoch - 1) / seq_length;

    int64_t sample_index = 0;
    int64_t doc_idx_index = 0;
    int32_t doc_offset = 0;

    out[0] = static_cast<int32_t>(doc_idx_index);
    out[1] = doc_offset;
    ++sample_index;

    while (sample_index <= num_samples) {
        int32_t remaining = seq_length + 1;
        while (remaining != 0) {
            const int32_t doc_id = doc_idx[doc_idx_index];
            const int32_t doc_length = sizes[doc_id] - doc_offset;
            remaining -= doc_length;
            if (remaining <= 0) {
                doc_offset += remaining + doc_length - 1;
                remaining = 0;
            } else {
                if (doc_idx_index + 1 >= doc_idx_len) {
                    // stream exhausted (can only happen on the final +1
                    // sentinel entry); clamp at the end
                    doc_offset = sizes[doc_id];
                    remaining = 0;
                } else {
                    ++doc_idx_index;
                    doc_offset = 0;
                }
            }
        }
        out[2 * sample_index] = static_cast<int32_t>(doc_idx_index);
        out[2 * sample_index + 1] = doc_offset;
        ++sample_index;
    }
}

// Greedy weight-balancing blend: for each output position pick the dataset
// whose emitted count is furthest behind weight * position.
void build_blending_indices(const double* weights, int32_t num_datasets,
                            int64_t size, uint8_t* dataset_index,
                            int64_t* dataset_sample_index) {
    int64_t current[256] = {0};
    for (int64_t i = 0; i < size; ++i) {
        double max_error = -1e300;
        int32_t best = 0;
        for (int32_t d = 0; d < num_datasets; ++d) {
            const double error =
                weights[d] * static_cast<double>(i + 1) -
                static_cast<double>(current[d]);
            if (error > max_error) {
                max_error = error;
                best = d;
            }
        }
        dataset_index[i] = static_cast<uint8_t>(best);
        dataset_sample_index[i] = current[best];
        ++current[best];
    }
}

}  // extern "C"
