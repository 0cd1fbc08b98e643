// Copied from native/ingest.cpp; equal to it apart from this line and the early return at the record count in sti_parse_pack_records.
// Native ingest: FASTA/FASTQ parsing + base encoding at memory
// bandwidth, feeding the TPU pipeline's packed read batches.
//
// Role: the reference pipeline's throughput-critical ingest is native
// (Jellyfish's C++ parsers — SURVEY.md §3.2); this is the rebuild's
// equivalent for the host side of the host->device boundary.  The
// Python layer (shannon_tpu/native/__init__.py) loads this via ctypes
// and falls back to the pure-Python parser when the shared object is
// unavailable (e.g. no compiler).
//
// API (C, ctypes-friendly):
//   sti_count_records(path) -> number of records, or -1 on error
//   sti_parse_pack(path, pad_len, codes_out[n*pad_len],
//                  lengths_out[n], n) -> records filled, or -1
//   sti_range_count(path, lo, hi) -> records whose header line STARTS
//                  in byte range [lo, hi), or -1
//   sti_range_parse(path, lo, hi, pad_len, codes, lengths, max) ->
//                  records filled for that byte range, or -1
//
// Byte-range contract (multi-host ingest, SURVEY.md §8 M5): a record
// belongs to the range containing its header line's first byte, so any
// partition of [0, file_size) yields every record exactly once and
// each host reads only ~its fraction of the file.  Resync after a seek:
// FASTA = next line starting '>'; FASTQ = next line starting '@' whose
// second-following line starts '+' (quality lines starting '@' are
// followed by a header then sequence, never '+', so the rule is exact
// on well-formed 4-line records).
//
// Records longer than pad_len are truncated; positions past a read's
// length hold 4 (BASE_INVALID), matching shannon_tpu.io.pack.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// A=0 C=1 G=2 T=3 (U=T), everything else invalid=4; matches
// shannon_tpu/io/dna.py exactly.
struct Lut {
    uint8_t t[256];
    Lut() {
        memset(t, 4, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
        t['U'] = t['u'] = 3;
    }
};
const Lut LUT;

struct Reader {
    FILE* f;
    char* buf;
    size_t cap;
    long start;  // byte offset where the last-read line begins
    long next;   // byte offset of the next line
    explicit Reader(const char* path)
        : f(fopen(path, "rb")), buf(nullptr), cap(0), start(0), next(0) {}
    ~Reader() {
        if (f) fclose(f);
        free(buf);
    }
    // getline without trailing newline; returns length or -1 at EOF
    long line() {
        start = next;
        ssize_t n = getline(&buf, &cap, f);
        if (n < 0) return -1;
        next = start + n;
        while (n > 0 && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) --n;
        buf[n] = 0;
        return n;
    }
};

enum Fmt { FMT_FASTA, FMT_FASTQ, FMT_BAD };

Fmt sniff(Reader& r, long& first_len) {
    for (;;) {
        first_len = r.line();
        if (first_len < 0) return FMT_BAD;
        if (first_len == 0) continue;
        if (r.buf[0] == '>') return FMT_FASTA;
        if (r.buf[0] == '@') return FMT_FASTQ;
        return FMT_BAD;
    }
}

Fmt sniff_file(const char* path) {
    Reader r(path);
    if (!r.f) return FMT_BAD;
    long first;
    return sniff(r, first);
}

// Position the reader so the next line() returns the first complete
// line whose start offset is >= lo (a line starts exactly at lo iff
// byte lo-1 is a newline, so backing up one byte and discarding one
// getline is exact).
bool seek_to_line(Reader& r, long lo) {
    if (lo <= 0) {
        if (fseek(r.f, 0, SEEK_SET) != 0) return false;
        r.next = 0;
        return true;
    }
    if (fseek(r.f, lo - 1, SEEK_SET) != 0) return false;
    r.next = lo - 1;
    return r.line() >= 0;
}

// One held line (content copy) for the FASTQ resync lookahead.
struct Held {
    char* s = nullptr;
    size_t cap = 0;
    long n = -1;  // -1 = empty slot
    long start = 0;
    void set(const char* src, long len, long st) {
        if (cap < (size_t)len + 1) {
            cap = (size_t)len + 1;
            s = (char*)realloc(s, cap);
        }
        memcpy(s, src, (size_t)len + 1);
        n = len;
        start = st;
    }
    ~Held() { free(s); }
};

void encode_row(const char* src, long n, int32_t pad_len, uint8_t* row,
                int32_t* len_out) {
    int32_t len = 0;
    for (long i = 0; i < n && len < pad_len; ++i)
        row[len++] = LUT.t[(uint8_t)src[i]];
    for (int32_t i = len; i < pad_len; ++i) row[i] = 4;
    *len_out = len;
}

}  // namespace

extern "C" {

// Longest record sequence length in bases (multi-line FASTA records
// sum their lines), or -1 on error.  Drives auto pad sizing
// (shannon_tpu.io.pack.auto_pad_length) so the native path never
// silently truncates: the Python wrapper scans this before allocating.
long sti_max_seq_len(const char* path) {
    Reader r(path);
    if (!r.f) return -1;
    long first;
    Fmt fmt = sniff(r, first);
    if (fmt == FMT_BAD) return -1;
    long best = 0, cur = 0, n;
    if (fmt == FMT_FASTA) {
        while ((n = r.line()) >= 0) {
            if (n > 0 && r.buf[0] == '>') {
                if (cur > best) best = cur;
                cur = 0;
            } else {
                cur += n;
            }
        }
        return cur > best ? cur : best;
    }
    for (;;) {
        n = r.line();  // sequence
        if (n < 0) return -1;
        if (n > best) best = n;
        if (r.line() < 0) return -1;  // '+'
        if (r.line() < 0) return -1;  // quals
        long h = r.line();            // next header (or EOF)
        if (h < 0) break;
        if (h == 0 || r.buf[0] != '@') return -1;
    }
    return best;
}

// Count records (so Python can allocate exact-size arrays).
long sti_count_records(const char* path) {
    Reader r(path);
    if (!r.f) return -1;
    long first;
    Fmt fmt = sniff(r, first);
    if (fmt == FMT_BAD) return -1;
    long count = 1;  // sniff consumed the first header
    if (fmt == FMT_FASTA) {
        long n;
        while ((n = r.line()) >= 0)
            if (n > 0 && r.buf[0] == '>') ++count;
    } else {
        // FASTQ: 4 lines per record
        long lines = 1, n;
        while ((n = r.line()) >= 0) ++lines;
        if (lines % 4 != 0) return -1;  // truncated file
        count = lines / 4;
    }
    return count;
}

// Parse + encode into caller-allocated buffers.  Returns records
// written or -1 on error.
long sti_parse_pack(const char* path, int32_t pad_len, uint8_t* codes,
                    int32_t* lengths, long max_records) {
    Reader r(path);
    if (!r.f) return -1;
    long first;
    Fmt fmt = sniff(r, first);
    if (fmt == FMT_BAD) return -1;

    long rec = 0;
    if (fmt == FMT_FASTA) {
        int32_t len = 0;
        uint8_t* row = codes;
        bool open = true;  // a record is open (header already consumed)
        long n;
        auto close_rec = [&]() {
            for (int32_t i = len; i < pad_len; ++i) row[i] = 4;
            lengths[rec] = len;
            ++rec;
        };
        while ((n = r.line()) >= 0) {
            if (n > 0 && r.buf[0] == '>') {
                if (rec >= max_records) return -1;
                close_rec();
                row = codes + rec * (long)pad_len;
                len = 0;
                open = true;
            } else {
                for (long i = 0; i < n && len < pad_len; ++i)
                    row[len++] = LUT.t[(uint8_t)r.buf[i]];
            }
        }
        if (open) {
            if (rec >= max_records) return -1;
            close_rec();
        }
    } else {
        long n;
        for (;;) {
            // current line buffer holds the header (sniff or loop end)
            n = r.line();  // sequence
            if (n < 0) return -1;
            if (rec >= max_records) return -1;
            uint8_t* row = codes + rec * (long)pad_len;
            int32_t len = 0;
            for (long i = 0; i < n && len < pad_len; ++i)
                row[len++] = LUT.t[(uint8_t)r.buf[i]];
            for (int32_t i = len; i < pad_len; ++i) row[i] = 4;
            lengths[rec] = len;
            ++rec;
            if (r.line() < 0) return -1;  // '+'
            if (r.line() < 0) return -1;  // quals
            long h = r.line();            // next header (or EOF)
            if (h < 0) break;
            if (h == 0 || r.buf[0] != '@') return -1;
        }
    }
    return rec;
}

// Parse + encode records [skip, skip + max_records) by RECORD INDEX
// (the pair-aligned multi-host ingest primitive: the left mate file is
// byte-range-split, the right file is then read at the SAME record
// range so mates stay co-resident on one host — byte-splitting the two
// files independently could misalign them).  The skip phase is a pure
// line scan (no encoding), so each host pays O(file) scanning but only
// O(file/H) parsing + encoding.  Returns records written or -1.
long sti_parse_pack_records(const char* path, long skip, int32_t pad_len,
                            uint8_t* codes, int32_t* lengths,
                            long max_records) {
    Reader r(path);
    if (!r.f) return -1;
    long first;
    Fmt fmt = sniff(r, first);
    if (fmt == FMT_BAD) return -1;
    long rec = 0;
    if (fmt == FMT_FASTA) {
        long seen = 0;  // records whose header has been consumed
        int32_t len = 0;
        uint8_t* row = nullptr;
        bool in_rec = skip == 0;  // sniff consumed record 0's header
        if (in_rec) {
            row = codes;
            len = 0;
        }
        seen = 1;
        long n;
        auto close_rec = [&]() {
            for (int32_t i = len; i < pad_len; ++i) row[i] = 4;
            lengths[rec] = len;
            ++rec;
        };
        while ((n = r.line()) >= 0) {
            if (n > 0 && r.buf[0] == '>') {
                if (in_rec) {
                    if (rec >= max_records) return rec;
                    close_rec();
                    if (rec >= max_records) return rec;  // stop at the count, not at EOF
                }
                in_rec = seen >= skip && rec < max_records;
                ++seen;
                if (in_rec) {
                    row = codes + rec * (long)pad_len;
                    len = 0;
                }
            } else if (in_rec) {
                for (long i = 0; i < n && len < pad_len; ++i)
                    row[len++] = LUT.t[(uint8_t)r.buf[i]];
            }
        }
        if (in_rec && rec < max_records) close_rec();
        return rec;
    }
    // FASTQ: 4 lines per record; sniff consumed record 0's header
    for (long i = 0; i < skip; ++i) {
        if (r.line() < 0 || r.line() < 0 || r.line() < 0) return -1;
        long h = r.line();  // next header
        if (h < 0) return 0;
        if (h == 0 || r.buf[0] != '@') return -1;
    }
    for (;;) {
        long n = r.line();  // sequence
        if (n < 0) return -1;
        if (rec >= max_records) break;
        encode_row(r.buf, n, pad_len, codes + rec * (long)pad_len,
                   &lengths[rec]);
        ++rec;
        if (r.line() < 0) return -1;  // '+'
        if (r.line() < 0) return -1;  // quals
        long h = r.line();            // next header (or EOF)
        if (h < 0) break;
        if (h == 0 || r.buf[0] != '@') return -1;
        if (rec >= max_records) break;
    }
    return rec;
}

// Records whose header line starts in byte range [lo, hi); -1 on error.
long sti_range_count(const char* path, long lo, long hi) {
    Fmt fmt = sniff_file(path);
    if (fmt == FMT_BAD) return -1;
    Reader r(path);
    if (!r.f || !seek_to_line(r, lo)) return -1;
    long count = 0;
    if (fmt == FMT_FASTA) {
        long n;
        while ((n = r.line()) >= 0) {
            if (r.start >= hi) break;
            if (n > 0 && r.buf[0] == '>') ++count;
        }
        return count;
    }
    // FASTQ: resync to a header ('@' line with '+' two lines later)
    Held h0, h1;
    long n;
    bool found = false;
    long hdr_start = 0;
    while ((n = r.line()) >= 0) {
        if (h0.n > 0 && h0.s[0] == '@' && n > 0 && r.buf[0] == '+') {
            hdr_start = h0.start;
            found = true;
            break;
        }
        h0.set(h1.n >= 0 ? h1.s : "", h1.n >= 0 ? h1.n : 0,
               h1.n >= 0 ? h1.start : 0);
        if (h1.n < 0) h0.n = -1;  // keep empty until h1 was real
        h1.set(r.buf, n, r.start);
    }
    if (!found || hdr_start >= hi) return 0;
    if (r.line() < 0) return -1;  // quality of the first record
    count = 1;
    for (;;) {
        long h = r.line();  // next header (or EOF)
        if (h < 0) break;
        if (r.start >= hi) break;
        if (h == 0 || r.buf[0] != '@') return -1;
        if (r.line() < 0 || r.line() < 0 || r.line() < 0) return -1;
        ++count;
    }
    return count;
}

// Parse + encode the records of byte range [lo, hi) (same contract as
// sti_range_count).  Returns records written or -1.
long sti_range_parse(const char* path, long lo, long hi, int32_t pad_len,
                     uint8_t* codes, int32_t* lengths, long max_records) {
    Fmt fmt = sniff_file(path);
    if (fmt == FMT_BAD) return -1;
    Reader r(path);
    if (!r.f || !seek_to_line(r, lo)) return -1;
    long rec = 0;
    if (fmt == FMT_FASTA) {
        int32_t len = 0;
        uint8_t* row = nullptr;
        bool in_rec = false;
        long n;
        auto close_rec = [&]() {
            for (int32_t i = len; i < pad_len; ++i) row[i] = 4;
            lengths[rec] = len;
            ++rec;
        };
        while ((n = r.line()) >= 0) {
            if (n > 0 && r.buf[0] == '>') {
                if (in_rec) {
                    if (rec >= max_records) return -1;
                    close_rec();
                }
                if (r.start >= hi) {
                    in_rec = false;
                    break;
                }
                row = codes + rec * (long)pad_len;
                len = 0;
                in_rec = true;
            } else if (in_rec) {
                for (long i = 0; i < n && len < pad_len; ++i)
                    row[len++] = LUT.t[(uint8_t)r.buf[i]];
            }
        }
        if (in_rec) {
            if (rec >= max_records) return -1;
            close_rec();
        }
        return rec;
    }
    // FASTQ
    Held h0, h1;
    long n;
    bool found = false;
    long hdr_start = 0;
    while ((n = r.line()) >= 0) {
        if (h0.n > 0 && h0.s[0] == '@' && n > 0 && r.buf[0] == '+') {
            hdr_start = h0.start;
            found = true;
            break;
        }
        h0.set(h1.n >= 0 ? h1.s : "", h1.n >= 0 ? h1.n : 0,
               h1.n >= 0 ? h1.start : 0);
        if (h1.n < 0) h0.n = -1;
        h1.set(r.buf, n, r.start);
    }
    if (!found || hdr_start >= hi) return 0;
    if (max_records < 1) return -1;
    // h1 holds the first record's sequence line
    encode_row(h1.s, h1.n, pad_len, codes, &lengths[0]);
    rec = 1;
    if (r.line() < 0) return -1;  // quality
    for (;;) {
        long h = r.line();  // header (or EOF)
        if (h < 0) break;
        if (r.start >= hi) break;
        if (h == 0 || r.buf[0] != '@') return -1;
        if (rec >= max_records) return -1;
        long sn = r.line();  // sequence
        if (sn < 0) return -1;
        encode_row(r.buf, sn, pad_len, codes + rec * (long)pad_len,
                   &lengths[rec]);
        ++rec;
        long pn = r.line();  // '+'
        if (pn < 0 || r.buf[0] != '+') return -1;
        if (r.line() < 0) return -1;  // quality
    }
    return rec;
}

}  // extern "C"
