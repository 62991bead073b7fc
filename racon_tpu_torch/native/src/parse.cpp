// Native streaming FASTA/FASTQ loader — the data-loader role the reference
// gets from the vendored bioparser library (used at src/polisher.cpp:86-99,
// 202-203, 229-231 with 1 GiB chunking). zlib's gzFile layer reads both
// plain and gzipped files transparently; records are tokenized here and
// exposed to Python as flat byte buffers + offset arrays, so the Python
// side only slices (no per-line Python work on multi-GiB read sets).
//
// Contract details matched to the reference's bioparser: record name is
// the header's first whitespace-delimited token; FASTA data may wrap over
// any number of lines; FASTQ is the wrapped variant (sequence lines until
// the '+' separator, quality lines until their total length reaches the
// sequence length).

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int64_t kReadBuf = 1 << 20;

struct SeqFile {
    gzFile file = nullptr;
    std::string path;
    bool fastq = false;
    bool eof = false;
    bool failed = false;

    // line reader
    std::vector<char> buf;
    int64_t buf_pos = 0;
    int64_t buf_len = 0;
    std::string pending;   // pushed-back header line
    bool has_pending = false;

    // current chunk's record storage
    std::vector<uint8_t> names, seqs, quals;
    std::vector<int64_t> name_offs{0}, seq_offs{0}, qual_offs{0};

    bool fill() {
        if (buf.empty()) {
            buf.resize(kReadBuf);
        }
        const int n = gzread(file, buf.data(), static_cast<unsigned>(kReadBuf));
        if (n < 0) {
            failed = true;  // decompression error (corrupt stream)
            return false;
        }
        if (n == 0) {
            // distinguish clean EOF from a truncated gzip stream: zlib only
            // sets gzeof after the end-of-stream marker was seen
            if (!gzeof(file)) {
                failed = true;
            }
            return false;
        }
        buf_pos = 0;
        buf_len = n;
        return true;
    }

    // next line without trailing \r\n; false at EOF
    bool next_line(std::string& line) {
        if (has_pending) {
            line.swap(pending);
            has_pending = false;
            return true;
        }
        line.clear();
        while (true) {
            if (buf_pos >= buf_len) {
                if (!fill()) {
                    return !line.empty();
                }
            }
            const char* start = buf.data() + buf_pos;
            const char* nl = static_cast<const char*>(
                memchr(start, '\n', buf_len - buf_pos));
            if (nl == nullptr) {
                line.append(start, buf_len - buf_pos);
                buf_pos = buf_len;
                continue;
            }
            line.append(start, nl - start);
            buf_pos += (nl - start) + 1;
            while (!line.empty() &&
                   (line.back() == '\r' || line.back() == ' ' ||
                    line.back() == '\t')) {
                line.pop_back();
            }
            return true;
        }
    }

    void push_back_line(std::string& line) {
        pending.swap(line);
        has_pending = true;
    }
};

void append_name(SeqFile* h, const std::string& header) {
    // first whitespace-delimited token after the marker char
    size_t end = 1;
    while (end < header.size() && header[end] != ' ' && header[end] != '\t') {
        ++end;
    }
    h->names.insert(h->names.end(), header.begin() + 1, header.begin() + end);
    h->name_offs.push_back(static_cast<int64_t>(h->names.size()));
}

// Returns payload bytes appended, or -1 on malformed input, 0 at EOF.
int64_t read_record(SeqFile* h) {
    std::string line;
    do {
        if (!h->next_line(line)) {
            if (h->failed) {
                return -1;  // corrupt/truncated input, not a clean EOF
            }
            h->eof = true;
            return 0;
        }
    } while (line.empty());

    const char marker = h->fastq ? '@' : '>';
    if (line[0] != marker) {
        return -1;
    }
    append_name(h, line);
    const size_t seq_start = h->seqs.size();

    if (!h->fastq) {
        while (h->next_line(line)) {
            if (line.empty()) {
                continue;
            }
            if (line[0] == '>') {
                h->push_back_line(line);
                break;
            }
            h->seqs.insert(h->seqs.end(), line.begin(), line.end());
        }
        h->seq_offs.push_back(static_cast<int64_t>(h->seqs.size()));
        h->qual_offs.push_back(h->qual_offs.back());
        const int64_t n = static_cast<int64_t>(h->seqs.size() - seq_start);
        return n > 0 ? n : -1;
    }

    // FASTQ: sequence until '+', quality until length matches
    bool saw_plus = false;
    while (h->next_line(line)) {
        if (line.empty()) {
            continue;
        }
        if (line[0] == '+') {
            saw_plus = true;
            break;
        }
        h->seqs.insert(h->seqs.end(), line.begin(), line.end());
    }
    const int64_t seq_len = static_cast<int64_t>(h->seqs.size() - seq_start);
    if (!saw_plus || seq_len == 0) {
        return -1;
    }
    const size_t qual_start = h->quals.size();
    while (static_cast<int64_t>(h->quals.size() - qual_start) < seq_len) {
        if (!h->next_line(line)) {
            return -1;
        }
        h->quals.insert(h->quals.end(), line.begin(), line.end());
    }
    if (static_cast<int64_t>(h->quals.size() - qual_start) != seq_len) {
        return -1;
    }
    h->seq_offs.push_back(static_cast<int64_t>(h->seqs.size()));
    h->qual_offs.push_back(static_cast<int64_t>(h->quals.size()));
    return 2 * seq_len;
}

}  // namespace

extern "C" {

void* rh_sf_open(const char* path, int32_t is_fastq) {
    gzFile f = gzopen(path, "rb");
    if (f == nullptr) {
        return nullptr;
    }
    gzbuffer(f, 1 << 20);
    auto* h = new SeqFile();
    h->file = f;
    h->path = path;
    h->fastq = is_fastq != 0;
    return h;
}

// Parse up to ~max_bytes of payload (-1 = all). Returns the number of
// records in this chunk, or -1 on malformed input. *more = 1 when the file
// has further records. Buffer pointers stay valid until the next call.
int64_t rh_sf_chunk(void* handle, int64_t max_bytes, int32_t* more,
                    const uint8_t** names, const int64_t** name_offs,
                    const uint8_t** seqs, const int64_t** seq_offs,
                    const uint8_t** quals, const int64_t** qual_offs) {
    auto* h = static_cast<SeqFile*>(handle);
    h->names.clear();
    h->seqs.clear();
    h->quals.clear();
    h->name_offs.assign(1, 0);
    h->seq_offs.assign(1, 0);
    h->qual_offs.assign(1, 0);

    int64_t total = 0;
    int64_t n_records = 0;
    while (!h->eof && (max_bytes < 0 || total < max_bytes)) {
        const int64_t n = read_record(h);
        if (n < 0 || h->failed) {
            h->failed = true;
            return -1;
        }
        if (n == 0) {
            break;
        }
        total += n;
        ++n_records;
    }
    *more = h->eof ? 0 : 1;
    *names = h->names.data();
    *name_offs = h->name_offs.data();
    *seqs = h->seqs.data();
    *seq_offs = h->seq_offs.data();
    *quals = h->quals.data();
    *qual_offs = h->qual_offs.data();
    return n_records;
}

void rh_sf_close(void* handle) {
    auto* h = static_cast<SeqFile*>(handle);
    if (h == nullptr) {
        return;
    }
    if (h->file != nullptr) {
        gzclose(h->file);
    }
    delete h;
}

}  // extern "C"
