/* A JSON fixture reader for the mock libcuda.so.1 and libnvidia-ml.so.1
 * (SURVEY.md §2.5: mock driver libraries driven by a fixture are how
 * the reference tests its interposer without a card).  The fixture is
 * one object whose "devices" array holds flat objects of strings,
 * numbers and booleans; top-level numbers are read as well:
 *
 *   {"ctx_mb": 500, "devices": [{"uuid": "GPU-...", "total_mb": 81559,
 *                                "healthy": true}]}
 *
 * Test code only: no card is involved, nothing here runs in a tenant on
 * the card. */
#ifndef VTPU_MOCK_FIXTURE_H_
#define VTPU_MOCK_FIXTURE_H_

#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>

#include <map>
#include <string>
#include <vector>

namespace mock {

typedef std::map<std::string, std::string> Object;

struct Fixture {
  bool ok = false;
  Object top;                  /* top-level scalars */
  std::vector<Object> devices; /* the "devices" array */

  double num(const Object& o, const char* key, double dflt) const {
    auto it = o.find(key);
    return it == o.end() ? dflt : atof(it->second.c_str());
  }
  std::string str(const Object& o, const char* key,
                  const char* dflt = "") const {
    auto it = o.find(key);
    return it == o.end() ? dflt : it->second;
  }
  bool flag(const Object& o, const char* key, bool dflt) const {
    auto it = o.find(key);
    return it == o.end() ? dflt : it->second == "true";
  }
};

class Reader {
 public:
  explicit Reader(const std::string& s) : s_(s) {}

  bool parse(Fixture* f) {
    ws();
    if (!eat('{')) return false;
    ws();
    if (eat('}')) return true;
    for (;;) {
      std::string key;
      if (!string(&key)) return false;
      ws();
      if (!eat(':')) return false;
      ws();
      if (peek() == '[') {
        if (!array(key == "devices" ? &f->devices : nullptr)) return false;
      } else {
        std::string v;
        if (!scalar(&v)) return false;
        f->top[key] = v;
      }
      ws();
      if (eat(',')) {
        ws();
        continue;
      }
      return eat('}');
    }
  }

 private:
  char peek() const { return i_ < s_.size() ? s_[i_] : '\0'; }
  bool eat(char c) {
    if (peek() != c) return false;
    i_++;
    return true;
  }
  void ws() {
    while (i_ < s_.size() && isspace((unsigned char)s_[i_])) i_++;
  }
  bool string(std::string* out) {
    if (!eat('"')) return false;
    while (i_ < s_.size() && s_[i_] != '"') {
      if (s_[i_] == '\\' && i_ + 1 < s_.size()) i_++;
      out->push_back(s_[i_++]);
    }
    return eat('"');
  }
  bool scalar(std::string* out) {
    if (peek() == '"') return string(out);
    while (i_ < s_.size() && (isalnum((unsigned char)s_[i_]) ||
                              s_[i_] == '.' || s_[i_] == '-' ||
                              s_[i_] == '+'))
      out->push_back(s_[i_++]);
    return !out->empty();
  }
  bool object(Object* o) {
    if (!eat('{')) return false;
    ws();
    if (eat('}')) return true;
    for (;;) {
      std::string key, v;
      if (!string(&key)) return false;
      ws();
      if (!eat(':')) return false;
      ws();
      if (!scalar(&v)) return false;
      (*o)[key] = v;
      ws();
      if (eat(',')) {
        ws();
        continue;
      }
      return eat('}');
    }
  }
  bool array(std::vector<Object>* out) {
    if (!eat('[')) return false;
    ws();
    if (eat(']')) return true;
    for (;;) {
      Object o;
      if (!object(&o)) return false;
      if (out) out->push_back(o);
      ws();
      if (eat(',')) {
        ws();
        continue;
      }
      return eat(']');
    }
  }

  const std::string& s_;
  size_t i_ = 0;
};

/* the fixture named by the environment variable `var`; ok=false when it
 * is unset, unreadable or not of the shape above */
inline Fixture load(const char* var) {
  Fixture f;
  const char* path = getenv(var);
  if (!path) return f;
  FILE* fp = fopen(path, "r");
  if (!fp) return f;
  std::string text;
  char buf[4096];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), fp)) > 0) text.append(buf, n);
  fclose(fp);
  f.ok = Reader(text).parse(&f);
  return f;
}

}  // namespace mock

#endif /* VTPU_MOCK_FIXTURE_H_ */
