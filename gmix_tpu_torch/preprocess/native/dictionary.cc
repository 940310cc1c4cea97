// Native engine for the word-replacing dictionary transform.
//
// Produces/consumes the same byte format as the reference preprocessor
// (src/preprocess/dictionary.cpp) - word codes in 80/3840/40960 frequency
// bands, capitalisation escapes, the &quot; token, byte escaping, and longest
// suffix/prefix fallback for unknown words >= 8 chars - but is structured as
// two phases: a TOKENIZER that case-folds the byte stream into
// literal/word/quote tokens, and an EMITTER that maps tokens to codes.
// Format compatibility (segmentation rules, code banding, escape set) is
// pinned by tests/test_reference_pinning.py, which diffs this engine against
// a freshly built reference dictionary-prep binary in both directions.
//
// Build: g++ -std=c++17 -O2 -fPIC -shared dictionary.cc -o libgmixdict.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t kCapitalized = 0x40;  // next word: first letter upper
constexpr uint8_t kUppercase = 0x07;    // next word: all letters upper
constexpr uint8_t kEndUpper = 0x06;     // ...stop uppercasing mid-run
constexpr uint8_t kEscape = 0x0C;       // next byte is literal
constexpr uint8_t kQuote = 0x08;        // expands to "quot;" after a '&'
const char kQuoteStr[] = "&quot;";

constexpr int kB1 = 80;
constexpr int kB2 = kB1 + 3840;
constexpr int kB3 = kB2 + 40960;
constexpr int kB4 = kB3 + 81920;

struct Sink {
  uint8_t* buf;
  size_t cap;
  size_t len = 0;
  bool overflow = false;
  void put(uint8_t c) {
    if (len < cap) buf[len++] = c;
    else overflow = true;
  }
  void put_str(const std::string& s) {
    for (char c : s) put(static_cast<uint8_t>(c));
  }
};

inline bool is_lower(uint8_t c) { return c >= 'a' && c <= 'z'; }
inline bool is_upper(uint8_t c) { return c >= 'A' && c <= 'Z'; }

// ---------------------------------------------------------------------------
// tokenizer
// ---------------------------------------------------------------------------

struct Token {
  enum Kind : uint8_t { kByte, kWord, kQuoteTok } kind;
  enum Caps : uint8_t { kNone, kFirst, kAll } caps = kNone;
  bool end_upper = false;  // all-caps word immediately followed by a lowercase
  std::string text;        // kWord: lowercased letters; kByte: one raw byte
};

// Case-folding word segmenter. A word is a maximal letter run that is either
// all-lowercase, Capitalized (one leading upper), or ALL-CAPS; a word also
// closes when it outgrows the dictionary's longest entry. "&quot;" is
// recognised by a lookahead cursor that runs concurrently with word building:
// its first five bytes still flow through the word machine, and the
// terminating ';' retroactively replaces whatever they accumulated with one
// quote token (the '&' itself was already flushed as a literal).
class Tokenizer {
 public:
  explicit Tokenizer(size_t max_word) : max_word_(max_word) {}

  std::vector<Token> run(const uint8_t* in, size_t n) {
    std::vector<Token> out;
    out.reserve(n / 4 + 8);
    for (size_t i = 0; i < n; ++i) step(in[i], out);
    close_word(out, /*followed_by_lower=*/false);
    return out;
  }

 private:
  void step(uint8_t c, std::vector<Token>& out) {
    if (c == static_cast<uint8_t>(kQuoteStr[quote_pos_])) {
      if (++quote_pos_ == sizeof(kQuoteStr) - 1) {
        quote_pos_ = 0;
        word_.clear();
        uppers_ = lowers_ = 0;
        out.push_back({Token::kQuoteTok});
        return;
      }
    } else {
      quote_pos_ = 0;  // no restart-on-mismatch: matches the format
    }

    const bool lo = is_lower(c), up = is_upper(c);
    const bool fits = word_.size() <= max_word_ &&
                      ((lo && uppers_ <= 1) || (up && lowers_ == 0));
    if (fits) {
      word_.push_back(static_cast<char>(lo ? c : c - 'A' + 'a'));
      (lo ? lowers_ : uppers_)++;
      return;
    }
    close_word(out, /*followed_by_lower=*/lo);
    if (lo) {
      word_.push_back(static_cast<char>(c));
      lowers_ = 1;
    } else if (up) {
      word_.push_back(static_cast<char>(c - 'A' + 'a'));
      uppers_ = 1;
    } else {
      Token t{Token::kByte};
      t.text.push_back(static_cast<char>(c));
      out.push_back(std::move(t));
    }
  }

  void close_word(std::vector<Token>& out, bool followed_by_lower) {
    if (word_.empty()) return;
    Token t{Token::kWord};
    t.caps = uppers_ > 1 ? Token::kAll : uppers_ == 1 ? Token::kFirst : Token::kNone;
    t.end_upper = t.caps == Token::kAll && followed_by_lower;
    t.text = std::move(word_);
    out.push_back(std::move(t));
    word_.clear();
    uppers_ = lowers_ = 0;
  }

  size_t max_word_;
  std::string word_;
  int uppers_ = 0, lowers_ = 0;
  int quote_pos_ = 0;
};

// ---------------------------------------------------------------------------
// dictionary + emitter
// ---------------------------------------------------------------------------

struct Dict {
  std::unordered_map<std::string, std::string> codes;     // word -> code bytes
  std::unordered_map<std::string, std::string> words;     // code bytes -> word
  size_t longest = 0;

  explicit Dict(const uint8_t* data, size_t n) {
    std::string line;
    int count = 0;
    for (size_t i = 0; i <= n; ++i) {
      uint8_t c = i < n ? data[i] : '\n';
      if (is_lower(c)) {
        line += static_cast<char>(c);
      } else if (!line.empty()) {
        if (line.size() > longest) longest = line.size();
        std::string code = word_code(count);
        codes[line] = code;
        words[code] = line;
        ++count;
        line.clear();
      }
    }
  }

  // frequency-band variable-length codes (1-3 bytes, all >= 0x80)
  static std::string word_code(int i) {
    std::string out;
    if (i < kB1) {
      out.push_back(static_cast<char>(0x80 + i));
    } else if (i < kB2) {
      int j = i - kB1;
      out.push_back(static_cast<char>(0xD0 + j / 80));
      out.push_back(static_cast<char>(0x80 + j % 80));
    } else if (i < kB3) {
      int j = i - kB2;
      out.push_back(static_cast<char>(0xF0 + (j / 80) / 32));
      out.push_back(static_cast<char>(0xD0 + (j / 80) % 32));
      out.push_back(static_cast<char>(0x80 + j % 80));
    } else if (i < kB4) {
      int j = i - kB2;
      out.push_back(static_cast<char>(0xD0 + (j / 80) / 32));
      out.push_back(static_cast<char>(0xD0 + (j / 80) % 32));
      out.push_back(static_cast<char>(0x80 + j % 80));
    }
    return out;
  }

  void emit_literal(uint8_t c, Sink& out) const {
    switch (c) {
      case kEndUpper:
      case kEscape:
      case kUppercase:
      case kCapitalized:
      case kQuote:
        out.put(kEscape);
        break;
      default:
        if (c >= 0x80) out.put(kEscape);
    }
    out.put(c);
  }

  // longest dictionary suffix, then longest dictionary prefix, both >= 7
  // chars and strictly shorter than the word; unmatched chars pass raw
  bool emit_partial(const std::string& w, Sink& out) const {
    if (w.size() <= 7) return false;
    const size_t window = std::min(w.size() - 1, longest);
    for (size_t len = window; len >= 7; --len) {
      auto it = codes.find(w.substr(w.size() - len));
      if (it != codes.end()) {
        for (size_t i = 0; i < w.size() - len; ++i)
          out.put(static_cast<uint8_t>(w[i]));
        out.put_str(it->second);
        return true;
      }
    }
    for (size_t len = window; len >= 7; --len) {
      auto it = codes.find(w.substr(0, len));
      if (it != codes.end()) {
        out.put_str(it->second);
        for (size_t i = len; i < w.size(); ++i)
          out.put(static_cast<uint8_t>(w[i]));
        return true;
      }
    }
    return false;
  }

  void emit_token(const Token& t, Sink& out) const {
    switch (t.kind) {
      case Token::kQuoteTok:
        out.put(kQuote);
        return;
      case Token::kByte:
        emit_literal(static_cast<uint8_t>(t.text[0]), out);
        return;
      case Token::kWord:
        break;
    }
    if (t.caps == Token::kAll) out.put(kUppercase);
    else if (t.caps == Token::kFirst) out.put(kCapitalized);
    auto it = codes.find(t.text);
    if (it != codes.end()) out.put_str(it->second);
    else if (!emit_partial(t.text, out)) out.put_str(t.text);
    if (t.end_upper) out.put(kEndUpper);
  }

  void encode(const uint8_t* in, size_t n, Sink& out) const {
    Tokenizer tok(longest);
    for (const Token& t : tok.run(in, n)) emit_token(t, out);
  }

  void decode(const uint8_t* in, size_t n, Sink& out) const {
    bool upper = false, capital = false;
    size_t i = 0;
    while (i < n) {
      uint8_t c = in[i++];
      if (c == kEscape) {
        upper = false;
        if (i < n) out.put(in[i++]);
      } else if (c == kQuote) {
        for (int k = 1; k < 6; ++k) out.put(static_cast<uint8_t>(kQuoteStr[k]));
      } else if (c == kUppercase) {
        upper = true;
      } else if (c == kCapitalized) {
        capital = true;
      } else if (c == kEndUpper) {
        upper = false;
      } else if (c >= 0x80) {
        std::string code(1, static_cast<char>(c));
        if (c > 0xCF && i < n) {
          uint8_t c2 = in[i++];
          code.push_back(static_cast<char>(c2));
          if (c2 > 0xCF && i < n) code.push_back(static_cast<char>(in[i++]));
        }
        auto it = words.find(code);
        if (it != words.end()) {
          const std::string& word = it->second;
          for (size_t k = 0; k < word.size(); ++k) {
            char wc = word[k];
            if (k == 0 && capital) { wc = wc - 'a' + 'A'; capital = false; }
            if (upper) wc = wc - 'a' + 'A';
            out.put(static_cast<uint8_t>(wc));
          }
        }
      } else {
        if (!is_lower(c) && !is_upper(c)) upper = false;
        if (capital || upper) c = c - 'a' + 'A';
        if (capital) capital = false;
        out.put(c);
      }
    }
  }
};

}  // namespace

extern "C" {

void* gd_new(const char* dict_data, size_t len) {
  return new Dict(reinterpret_cast<const uint8_t*>(dict_data), len);
}

void gd_free(void* h) { delete static_cast<Dict*>(h); }

long long gd_encode(void* h, const char* in, size_t n, char* out, size_t cap) {
  Sink sink{reinterpret_cast<uint8_t*>(out), cap};
  static_cast<Dict*>(h)->encode(reinterpret_cast<const uint8_t*>(in), n, sink);
  return sink.overflow ? -1 : static_cast<long long>(sink.len);
}

long long gd_decode(void* h, const char* in, size_t n, char* out, size_t cap) {
  Sink sink{reinterpret_cast<uint8_t*>(out), cap};
  static_cast<Dict*>(h)->decode(reinterpret_cast<const uint8_t*>(in), n, sink);
  return sink.overflow ? -1 : static_cast<long long>(sink.len);
}

}  // extern "C"
