// fastcsv — native CSV parser for the dpsvm_tpu_torch data path (a copy
// of the JAX package's parser, so both packages read a file alike).
//
// Native-runtime equivalent of the reference's C++ loader (parse.cpp:10-43),
// which parses "label,f1,...,fd" lines with iostream/stoi/stof. That design
// is correct but slow (stringstream per line); this one reads the whole file
// once and scans it with strtof, parsing ~100x faster, which matters because
// every training run front-loads a full-dataset parse (the reference parses
// the FULL csv on every MPI rank, svmTrainMain.cpp:180).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (dpsvm_tpu_torch/utils/native.py). No pybind11 dependency.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Inspect the file: number of data lines and number of comma-separated
// fields on the first non-empty line (label + d features -> d+1 fields).
// Returns 0 on success, negative on error.
int fastcsv_shape(const char* path, long* n_rows, long* n_fields) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return -1;
    long rows = 0, fields = 0;
    bool counted_fields = false, line_has_data = false;
    std::vector<char> buf(1 << 20);
    size_t got;
    while ((got = std::fread(buf.data(), 1, buf.size(), fp)) > 0) {
        for (size_t i = 0; i < got; ++i) {
            char ch = buf[i];
            if (ch == '\n') {
                if (line_has_data) {
                    ++rows;
                    if (!counted_fields) { ++fields; counted_fields = true; }
                }
                line_has_data = false;
            } else if (ch != '\r') {
                line_has_data = true;
                if (!counted_fields && ch == ',') ++fields;
            }
        }
    }
    if (line_has_data) {
        ++rows;
        if (!counted_fields) { ++fields; }
    }
    std::fclose(fp);
    if (rows == 0 || fields < 2) return -2;
    *n_rows = rows;
    *n_fields = fields;
    return 0;
}

// Parse up to n_rows lines of "label,f1,...,fd" into caller-allocated
// x (n_rows * d floats, row-major) and y (n_rows ints), d = n_fields - 1.
// Returns number of rows parsed, or negative on error.
long fastcsv_parse(const char* path, long n_rows, long n_fields,
                   float* x, int* y) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return -1;
    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    std::vector<char> data((size_t)size + 1);
    if (std::fread(data.data(), 1, (size_t)size, fp) != (size_t)size) {
        std::fclose(fp);
        return -2;
    }
    std::fclose(fp);
    data[(size_t)size] = '\0';

    const long d = n_fields - 1;
    char* p = data.data();
    char* end_of_data = data.data() + size;
    long row = 0;
    while (row < n_rows && p < end_of_data) {
        // Skip blank lines.
        while (p < end_of_data && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end_of_data) break;
        // Bound this row's parse to its own line: strtof/strtol skip
        // leading whitespace INCLUDING newlines, so a ragged (short) row
        // would otherwise silently consume the next line's label as a
        // feature and shift every subsequent row.
        char* line_end = p;
        while (line_end < end_of_data && *line_end != '\n') ++line_end;
        char saved = *line_end;
        *line_end = '\0';
        char* next = nullptr;
        y[row] = (int)std::strtol(p, &next, 10);
        if (next == p) { *line_end = saved; return -3; }
        p = next;
        float* xrow = x + row * d;
        for (long j = 0; j < d; ++j) {
            if (p >= line_end) { *line_end = saved; return -4; }  // ragged row
            if (*p == ',') ++p;
            xrow[j] = std::strtof(p, &next);
            if (next == p) { *line_end = saved; return -3; }
            p = next;
        }
        *line_end = saved;
        p = line_end;
        ++row;
    }
    return row;
}

// Write the text model format (gamma line, b line, then one
// "alpha,y,x1,...,xd" row per support vector — the layout of the
// reference's distributed writer, svmTrainMain.cpp:386-416). The Python
// fallback calls repr() per float (~15M calls for an MNIST-scale model);
// this writes with %.9g, which round-trips float32 exactly.
long fastmodel_write(const char* path, float gamma, float b,
                     const float* alpha, const int* y, const float* x,
                     long n_sv, long d) {
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return -1;
    std::vector<char> iobuf(1 << 20);
    std::setvbuf(fp, iobuf.data(), _IOFBF, iobuf.size());
    std::fprintf(fp, "%.9g\n%.9g\n", (double)gamma, (double)b);
    for (long i = 0; i < n_sv; ++i) {
        std::fprintf(fp, "%.9g,%d", (double)alpha[i], y[i]);
        const float* row = x + i * d;
        for (long j = 0; j < d; ++j) {
            std::fprintf(fp, ",%.9g", (double)row[j]);
        }
        std::fputc('\n', fp);
    }
    if (std::fclose(fp) != 0) return -2;
    return n_sv;
}

}  // extern "C"
