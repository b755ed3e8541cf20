// C++ task-submission frontend for the ray_tpu_torch head.
//
// Ref analogs: cpp/include/ray/api.h + cpp/src/ray/runtime/task/
// task_submitter.h:26 (the reference's C++ public API submits tasks by
// function descriptor through the shared CoreWorker). Re-design for the
// framed-socket control plane: this client speaks the head's wire
// protocol directly — it EMITS the one fixed pickle shape the protocol
// needs (a (msg_type, request_id, bytes) tuple; core/protocol.py
// XLANG_CALL) and receives replies as RAW frames of JSON, so no Python
// runtime and no pickle PARSER exist on the C++ side. Submission is by
// function descriptor ("module:qualname"), the cross-language pattern of
// python/ray/cross_language.py:15; the head's side is
// ray_tpu_torch/core/head.py `_h_xlang_call` and `_xlang_execute`.
//
// Usage:
//   task_client <addr> <module:qualname> [json-args] [json-options]
//   task_client <addr> actor-create <module:Class> [json-args] [json-opts]
//   task_client <addr> actor-call <actor-name> <method> [json-args]
//   task_client <addr> actor-kill <actor-name>
// The actor subcommands are the C++ actor API (ref analog:
// cpp/src/ray/runtime/task/task_submitter.h:26 actor creation/submission
// paths): create prints the registered actor name, call prints the
// method result, kill tears the actor down. Exit 0 iff status == "ok".
//
// Build: `python -m ray_tpu_torch.native.build` (g++ -O2 -std=c++17, into
// .build/ray_tpu_torch/native/task_client-<hash>; native/build.py
// build_binary("task_client") returns the path).

#include <arpa/inet.h>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <netdb.h>
#include <string>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kRawBit = 1ULL << 63;
constexpr int kXlangCall = 67;  // core/protocol.py XLANG_CALL

// ---- minimal pickle WRITER for the one frame shape we send -----------------
// (int, int, bytes) tuple, pickle protocol 3:
//   \x80\x03  PROTO 3
//   J <i32le> BININT            (msg_type)
//   J <i32le> BININT            (request_id)
//   C <u8> .. / B <u32le> ..    SHORT_BINBYTES / BINBYTES (payload)
//   \x87      TUPLE3
//   .         STOP
std::string PickleCall(int msg_type, int request_id,
                       const std::string& payload) {
  std::string out;
  out += "\x80\x03";
  auto put_int = [&out](int32_t v) {
    out += 'J';
    char b[4];
    memcpy(b, &v, 4);  // little-endian hosts (x86/arm)
    out.append(b, 4);
  };
  put_int(msg_type);
  put_int(request_id);
  if (payload.size() < 256) {
    out += 'C';
    out += static_cast<char>(payload.size());
  } else {
    out += 'B';
    uint32_t n = payload.size();
    char b[4];
    memcpy(b, &n, 4);
    out.append(b, 4);
  }
  out += payload;
  out += '\x87';
  out += '.';
  return out;
}

// ---- socket helpers --------------------------------------------------------

int DialTcp(const std::string& host, const std::string& port) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0) return -1;
  int fd = -1;
  for (addrinfo* p = res; p; p = p->ai_next) {
    fd = socket(p->ai_family, p->ai_socktype, p->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, p->ai_addr, p->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  return fd;
}

int DialUnix(const std::string& path) {
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", path.c_str());
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

bool WriteAll(int fd, const char* data, size_t n) {
  while (n) {
    ssize_t w = write(fd, data, n);
    if (w <= 0) return false;
    data += w;
    n -= w;
  }
  return true;
}

bool ReadAll(int fd, char* data, size_t n) {
  while (n) {
    ssize_t r = read(fd, data, n);
    if (r <= 0) return false;
    data += r;
    n -= r;
  }
  return true;
}

bool SendFrame(int fd, const std::string& payload) {
  uint64_t len = payload.size();
  char hdr[8];
  memcpy(hdr, &len, 8);
  return WriteAll(fd, hdr, 8) && WriteAll(fd, payload.data(),
                                          payload.size());
}

// Reads frames until a RAW frame arrives (pickled frames are
// length-skipped — this client never parses pickle); returns its bytes.
bool ReadRawFrame(int fd, std::string* out) {
  for (;;) {
    char hdr[8];
    if (!ReadAll(fd, hdr, 8)) return false;
    uint64_t len;
    memcpy(&len, hdr, 8);
    const bool raw = len & kRawBit;
    len &= ~kRawBit;
    std::vector<char> buf(len);
    if (!ReadAll(fd, buf.data(), len)) return false;
    if (raw) {
      out->assign(buf.data(), len);
      return true;
    }
    // else: a pickled frame for some other party (pubsub etc.) — skip.
  }
}

// ---- tiny JSON field extraction (flat string fields of our reply) ----------

std::string JsonStringField(const std::string& js, const std::string& key) {
  const std::string pat = "\"" + key + "\":";
  size_t i = js.find(pat);
  if (i == std::string::npos) return "";
  i += pat.size();
  while (i < js.size() && (js[i] == ' ')) i++;
  if (i >= js.size()) return "";
  if (js[i] == '"') {
    std::string out;
    for (size_t j = i + 1; j < js.size(); j++) {
      if (js[j] == '\\' && j + 1 < js.size()) {
        out += js[++j];
      } else if (js[j] == '"') {
        return out;
      } else {
        out += js[j];
      }
    }
    return out;
  }
  // non-string value: scan to the matching end at depth 0
  int depth = 0;
  size_t j = i;
  for (; j < js.size(); j++) {
    char c = js[j];
    if (c == '[' || c == '{') depth++;
    if (c == ']' || c == '}') {
      if (depth == 0) break;
      depth--;
    }
    if ((c == ',') && depth == 0) break;
  }
  return js.substr(i, j - i);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s <host:port|unix:/path> <module:qualname> "
            "[json-args] [json-options]\n",
            argv[0]);
    return 2;
  }
  std::string addr = argv[1];
  if (addr.rfind("tcp:", 0) == 0) addr = addr.substr(4);
  int fd;
  if (addr.rfind("unix:", 0) == 0) {
    fd = DialUnix(addr.substr(5));
  } else {
    size_t colon = addr.rfind(':');
    if (colon == std::string::npos) {
      fprintf(stderr, "bad address %s\n", addr.c_str());
      return 2;
    }
    fd = DialTcp(addr.substr(0, colon), addr.substr(colon + 1));
  }
  if (fd < 0) {
    fprintf(stderr, "connect failed: %s\n", argv[1]);
    return 2;
  }

  const std::string cmd = argv[2];
  std::string req;
  if (cmd == "actor-create") {
    if (argc < 4) {
      fprintf(stderr, "actor-create needs <module:Class>\n");
      return 2;
    }
    req = std::string("{\"op\":\"actor_create\",\"class\":\"") + argv[3] +
          "\",\"args\":" + (argc > 4 ? argv[4] : "[]") +
          ",\"options\":" + (argc > 5 ? argv[5] : "{}") + "}";
  } else if (cmd == "actor-call") {
    if (argc < 5) {
      fprintf(stderr, "actor-call needs <actor-name> <method>\n");
      return 2;
    }
    req = std::string("{\"op\":\"actor_call\",\"actor\":\"") + argv[3] +
          "\",\"method\":\"" + argv[4] +
          "\",\"args\":" + (argc > 5 ? argv[5] : "[]") + "}";
  } else if (cmd == "actor-kill") {
    if (argc < 4) {
      fprintf(stderr, "actor-kill needs <actor-name>\n");
      return 2;
    }
    req = std::string("{\"op\":\"actor_kill\",\"actor\":\"") + argv[3] +
          "\"}";
  } else {
    // default: normal-task submission by function descriptor
    req = std::string("{\"op\":\"submit\",\"function\":\"") + cmd +
          "\",\"args\":" + (argc > 3 ? argv[3] : "[]") +
          ",\"options\":" + (argc > 4 ? argv[4] : "{}") + "}";
  }
  const int rid = 1;
  if (!SendFrame(fd, PickleCall(kXlangCall, rid, req))) {
    fprintf(stderr, "send failed\n");
    return 2;
  }
  std::string reply;
  if (!ReadRawFrame(fd, &reply)) {
    fprintf(stderr, "connection closed before reply\n");
    return 2;
  }
  close(fd);
  const std::string status = JsonStringField(reply, "status");
  if (status != "ok") {
    fprintf(stderr, "error: %s\n",
            JsonStringField(reply, "error").c_str());
    return 1;
  }
  printf("%s\n", JsonStringField(reply, "result").c_str());
  return 0;
}
