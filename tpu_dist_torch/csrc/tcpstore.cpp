// TCPStore — native key-value control-plane store (c10d TCPStore parity).
//
// The port's copy of tpu_dist/csrc/tcpstore.cpp, unchanged but for these
// comments and the prefix of its C symbols: the same server and client on
// the same wire, so either package's client talks to either package's
// server.  The launcher hosts it on node 0 for free-port negotiation,
// worker liveness and barriers, before (or without) torch.distributed;
// torch's own c10d store behind env:// is a different server on
// MASTER_PORT.  Host code, built with g++ (tpu_dist_torch/ops/_build.py),
// not a kernel.
//
// Wire protocol (all integers little-endian):
//   request : u8 op | u32 key_len | key bytes | u32 payload_len | payload
//   response: u32 status(0=ok) | u32 data_len | data
// Ops: 1=SET 2=GET(blocking) 3=ADD(i64 delta -> i64 new) 4=CHECK 5=DELETE
//      6=NUMKEYS 7=WAIT_GE(i64 target; blocks until int(key) >= target)
//      8=DELETE_PREFIX(erase every key starting with `key` -> i64 count;
//        the restart-time reaper for a crashed generation's stale
//        tpu_dist/g{gen}/... payload keys)
//
// Exposed via a C ABI (ctypes-friendly) whose symbols carry the prefix
// tdt_store_, apart from the JAX package's tpudist_store_ ones, so that one
// process can load both libraries; the Python wrapper lives in
// tpu_dist_torch/dist/store.py, with a pure-Python implementation of the
// same protocol as fallback.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Op : uint8_t {
  OP_SET = 1,
  OP_GET = 2,
  OP_ADD = 3,
  OP_CHECK = 4,
  OP_DELETE = 5,
  OP_NUMKEYS = 6,
  OP_WAIT_GE = 7,
  OP_DELETE_PREFIX = 8,
};

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool send_u32(int fd, uint32_t v) { return send_all(fd, &v, 4); }
bool recv_u32(int fd, uint32_t* v) { return recv_all(fd, v, 4); }

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> handlers;
  std::vector<int> client_fds;
  std::mutex handlers_mu;

  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> kv;

  ~Server() { stop(); }

  bool start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    if (::listen(listen_fd, 128) < 0) return false;
    accept_thread = std::thread([this] { accept_loop(); });
    return true;
  }

  void stop() {
    if (stopping.exchange(true)) return;
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
    }
    cv.notify_all();
    if (accept_thread.joinable()) accept_thread.join();
    // Wake handler threads blocked in recv on idle client connections —
    // without this, join() below deadlocks on any still-connected client.
    // Then join WITHOUT holding handlers_mu: a handler's exit path locks
    // it to deregister its fd (handle() epilogue), so joining under the
    // mutex deadlocks whenever a client disconnects concurrently with
    // stop — observed as an intermittent hang when two elastic launchers
    // tear down at the same moment.
    std::vector<std::thread> to_join;
    {
      std::lock_guard<std::mutex> g(handlers_mu);
      for (int fd : client_fds) ::shutdown(fd, SHUT_RDWR);
      to_join.swap(handlers);
    }
    for (auto& t : to_join)
      if (t.joinable()) t.join();
  }

  void accept_loop() {
    while (!stopping) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping) break;
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(handlers_mu);
      client_fds.push_back(fd);
      handlers.emplace_back([this, fd] { handle(fd); });
    }
  }

  void reply(int fd, uint32_t status, const std::string& data) {
    send_u32(fd, status);
    send_u32(fd, static_cast<uint32_t>(data.size()));
    if (!data.empty()) send_all(fd, data.data(), data.size());
  }

  static int64_t as_i64(const std::string& s) {
    int64_t v = 0;
    std::memcpy(&v, s.data(), std::min(s.size(), sizeof(v)));
    return v;
  }

  void handle(int fd) {
    while (!stopping) {
      uint8_t op;
      if (!recv_all(fd, &op, 1)) break;
      uint32_t klen;
      if (!recv_u32(fd, &klen) || klen > (1u << 20)) break;
      std::string key(klen, '\0');
      if (klen && !recv_all(fd, &key[0], klen)) break;
      uint32_t plen;
      if (!recv_u32(fd, &plen) || plen > (1u << 30)) break;
      std::string payload(plen, '\0');
      if (plen && !recv_all(fd, &payload[0], plen)) break;

      switch (op) {
        case OP_SET: {
          {
            std::lock_guard<std::mutex> g(mu);
            kv[key] = payload;
          }
          cv.notify_all();
          reply(fd, 0, "");
          break;
        }
        case OP_GET: {
          std::unique_lock<std::mutex> g(mu);
          cv.wait(g, [&] { return stopping || kv.count(key); });
          if (stopping) {
            reply(fd, 1, "");
            break;
          }
          std::string v = kv[key];
          g.unlock();
          reply(fd, 0, v);
          break;
        }
        case OP_ADD: {
          int64_t delta = as_i64(payload);
          int64_t nv;
          {
            std::lock_guard<std::mutex> g(mu);
            int64_t cur = kv.count(key) ? as_i64(kv[key]) : 0;
            nv = cur + delta;
            std::string s(sizeof(nv), '\0');
            std::memcpy(&s[0], &nv, sizeof(nv));
            kv[key] = s;
          }
          cv.notify_all();
          std::string out(sizeof(nv), '\0');
          std::memcpy(&out[0], &nv, sizeof(nv));
          reply(fd, 0, out);
          break;
        }
        case OP_CHECK: {
          std::lock_guard<std::mutex> g(mu);
          reply(fd, 0, kv.count(key) ? "1" : "0");
          break;
        }
        case OP_DELETE: {
          size_t n;
          {
            std::lock_guard<std::mutex> g(mu);
            n = kv.erase(key);
          }
          reply(fd, 0, n ? "1" : "0");
          break;
        }
        case OP_NUMKEYS: {
          std::lock_guard<std::mutex> g(mu);
          uint32_t n = static_cast<uint32_t>(kv.size());
          std::string out(4, '\0');
          std::memcpy(&out[0], &n, 4);
          reply(fd, 0, out);
          break;
        }
        case OP_WAIT_GE: {
          int64_t target = as_i64(payload);
          std::unique_lock<std::mutex> g(mu);
          cv.wait(g, [&] {
            return stopping || (kv.count(key) && as_i64(kv[key]) >= target);
          });
          reply(fd, stopping ? 1 : 0, "");
          break;
        }
        case OP_DELETE_PREFIX: {
          int64_t n = 0;
          {
            std::lock_guard<std::mutex> g(mu);
            // std::map is ordered: every key with this prefix is a
            // contiguous range starting at lower_bound(prefix)
            auto it = kv.lower_bound(key);
            while (it != kv.end() &&
                   it->first.compare(0, key.size(), key) == 0) {
              it = kv.erase(it);
              ++n;
            }
          }
          std::string out(sizeof(n), '\0');
          std::memcpy(&out[0], &n, sizeof(n));
          reply(fd, 0, out);
          break;
        }
        default:
          reply(fd, 2, "");
          break;
      }
    }
    ::close(fd);
    // Prune so stop() never calls shutdown() on a reused fd number.
    std::lock_guard<std::mutex> g(handlers_mu);
    client_fds.erase(std::remove(client_fds.begin(), client_fds.end(), fd),
                     client_fds.end());
  }
};

struct Client {
  int fd = -1;
  std::mutex mu;

  ~Client() {
    if (fd >= 0) ::close(fd);
  }

  bool connect_to(const char* host, int port, int timeout_ms) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    char portbuf[16];
    snprintf(portbuf, sizeof(portbuf), "%d", port);
    // Retry until the server comes up (ranks may start before the master),
    // bounded by timeout_ms — the behavior c10d's TCPStore client has.
    const int step_ms = 50;
    int waited = 0;
    for (;;) {
      if (getaddrinfo(host, portbuf, &hints, &res) == 0) {
        fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
        if (fd >= 0 &&
            ::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
          freeaddrinfo(res);
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          return true;
        }
        if (fd >= 0) ::close(fd);
        fd = -1;
        freeaddrinfo(res);
        res = nullptr;
      }
      if (waited >= timeout_ms) return false;
      usleep(step_ms * 1000);
      waited += step_ms;
    }
  }

  // Returns status, fills out (caller frees via tdt_store_free).
  int request(uint8_t op, const char* key, const uint8_t* payload,
              uint32_t plen, uint8_t** out, uint32_t* out_len) {
    std::lock_guard<std::mutex> g(mu);
    uint32_t klen = static_cast<uint32_t>(strlen(key));
    if (!send_all(fd, &op, 1) || !send_u32(fd, klen) ||
        !send_all(fd, key, klen) || !send_u32(fd, plen) ||
        (plen && !send_all(fd, payload, plen)))
      return -1;
    uint32_t status, dlen;
    if (!recv_u32(fd, &status) || !recv_u32(fd, &dlen)) return -1;
    uint8_t* data = nullptr;
    if (dlen) {
      data = static_cast<uint8_t*>(malloc(dlen));
      if (!recv_all(fd, data, dlen)) {
        free(data);
        return -1;
      }
    }
    if (out) {
      *out = data;
      *out_len = dlen;
    } else {
      free(data);
    }
    return static_cast<int>(status);
  }
};

}  // namespace

extern "C" {

void* tdt_store_server_start(int port) {
  auto* s = new Server();
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int tdt_store_server_port(void* h) {
  return h ? static_cast<Server*>(h)->port : -1;
}

void tdt_store_server_stop(void* h) {
  if (h) delete static_cast<Server*>(h);
}

void* tdt_store_client_connect(const char* host, int port,
                                   int timeout_ms) {
  auto* c = new Client();
  if (!c->connect_to(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

void tdt_store_client_close(void* h) {
  if (h) delete static_cast<Client*>(h);
}

int tdt_store_set(void* h, const char* key, const uint8_t* val, int len) {
  return static_cast<Client*>(h)->request(OP_SET, key, val,
                                          static_cast<uint32_t>(len), nullptr,
                                          nullptr);
}

int tdt_store_get(void* h, const char* key, uint8_t** out, int* out_len) {
  uint32_t n = 0;
  int st = static_cast<Client*>(h)->request(OP_GET, key, nullptr, 0, out, &n);
  *out_len = static_cast<int>(n);
  return st;
}

// Returns status (0 ok); the new counter value lands in *result so that
// negative counters are not conflated with errors.
int tdt_store_add(void* h, const char* key, long long delta,
                      long long* result) {
  uint8_t buf[8];
  std::memcpy(buf, &delta, 8);
  uint8_t* out = nullptr;
  uint32_t n = 0;
  int st =
      static_cast<Client*>(h)->request(OP_ADD, key, buf, 8, &out, &n);
  long long v = 0;
  if (st == 0 && out && n >= 8) std::memcpy(&v, out, 8);
  free(out);
  if (result) *result = v;
  return st;
}

int tdt_store_check(void* h, const char* key) {
  uint8_t* out = nullptr;
  uint32_t n = 0;
  int st = static_cast<Client*>(h)->request(OP_CHECK, key, nullptr, 0, &out, &n);
  int r = (st == 0 && out && n && out[0] == '1') ? 1 : 0;
  free(out);
  return st == 0 ? r : -1;
}

int tdt_store_delete(void* h, const char* key) {
  uint8_t* out = nullptr;
  uint32_t n = 0;
  int st =
      static_cast<Client*>(h)->request(OP_DELETE, key, nullptr, 0, &out, &n);
  int r = (st == 0 && out && n && out[0] == '1') ? 1 : 0;
  free(out);
  return st == 0 ? r : -1;
}

int tdt_store_num_keys(void* h) {
  uint8_t* out = nullptr;
  uint32_t n = 0;
  int st =
      static_cast<Client*>(h)->request(OP_NUMKEYS, "", nullptr, 0, &out, &n);
  uint32_t v = 0;
  if (st == 0 && out && n >= 4) std::memcpy(&v, out, 4);
  free(out);
  return st == 0 ? static_cast<int>(v) : -1;
}

// Returns status (0 ok); the number of erased keys lands in *count.
int tdt_store_delete_prefix(void* h, const char* prefix,
                                long long* count) {
  uint8_t* out = nullptr;
  uint32_t n = 0;
  int st = static_cast<Client*>(h)->request(OP_DELETE_PREFIX, prefix, nullptr,
                                            0, &out, &n);
  long long v = 0;
  if (st == 0 && out && n >= 8) std::memcpy(&v, out, 8);
  free(out);
  if (count) *count = v;
  return st;
}

int tdt_store_wait_ge(void* h, const char* key, long long target) {
  uint8_t buf[8];
  std::memcpy(buf, &target, 8);
  return static_cast<Client*>(h)->request(OP_WAIT_GE, key, buf, 8, nullptr,
                                          nullptr);
}

void tdt_store_free(uint8_t* p) { free(p); }

}  // extern "C"
