// Native HTTP/1.1 front: epoll accept/parse/keep-alive/write in C++.
//
// Copied from ucfp_tpu/native/httpfront.cpp unchanged but for this
// comment. The reference's server is native (axum/hyper on tokio); this
// is the equivalent IO front. The C++ side owns sockets,
// request parsing, body limits, and response writing; the Python side
// pulls parsed requests from a queue (ucfp_http_next) and pushes
// responses (ucfp_http_respond) — handler logic stays in Python where
// the device pipeline lives.
//
// Concurrency model: one epoll thread; at most ONE in-flight request
// per connection (the next request on a keep-alive socket is not parsed
// until the response for the previous one is written), so responses
// can arrive from Python in any order without per-connection
// reordering. Body limit enforced during read with a native 413.
//
// C ABI (ctypes): see UcfpHttpReq below. Strings are malloc'd copies
// owned by the caller until ucfp_http_free_req.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Conn {
  int fd = -1;
  std::string peer;           // client IP (per-IP limits upstream)
  std::string rbuf;           // unparsed input
  std::string wbuf;           // pending output
  bool in_flight = false;     // a request awaits its response
  bool close_after = false;
  uint64_t current_req = 0;
};

struct PendingReq {
  uint64_t id;
  std::string method, path, headers, body, peer;
};

struct PendingResp {
  uint64_t id;
  std::string bytes;
  bool close_after;
};

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;
  int port = 0;
  uint32_t body_limit = 16u << 20;
  std::thread io;
  bool stopping = false;

  std::mutex mu;
  std::condition_variable cv;
  std::deque<PendingReq> ready;           // parsed, waiting for Python
  std::deque<PendingResp> responses;      // from Python, to be written
  std::unordered_map<uint64_t, int> req_conn;  // req id -> fd
  std::unordered_map<int, Conn> conns;
  uint64_t next_id = 1;
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void arm(Server* s, int fd, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
}

void close_conn(Server* s, int fd) {
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
  s->conns.erase(fd);
}

std::string simple_response(int status, const char* text, const char* body,
                            bool keep) {
  char head[256];
  int blen = static_cast<int>(strlen(body));
  snprintf(head, sizeof(head),
           "HTTP/1.1 %d %s\r\ncontent-type: application/json\r\n"
           "content-length: %d\r\nconnection: %s\r\n\r\n",
           status, text, blen, keep ? "keep-alive" : "close");
  return std::string(head) + body;
}

// Try to parse one request from c->rbuf. Returns 1 on parsed, 0 if more
// data needed, -1 on protocol error (error response already queued).
int try_parse(Server* s, Conn* c) {
  size_t hdr_end = c->rbuf.find("\r\n\r\n");
  if (hdr_end == std::string::npos) {
    if (c->rbuf.size() > 32768) {
      c->wbuf += simple_response(431, "Request Header Fields Too Large",
                                 "{\"error\":\"headers_too_large\"}", false);
      c->close_after = true;
      return -1;
    }
    return 0;
  }
  std::string head = c->rbuf.substr(0, hdr_end);
  size_t line_end = head.find("\r\n");
  std::string req_line = head.substr(0, line_end == std::string::npos
                                            ? head.size() : line_end);
  size_t sp1 = req_line.find(' ');
  size_t sp2 = req_line.rfind(' ');
  if (sp1 == std::string::npos || sp2 == sp1) {
    c->wbuf += simple_response(400, "Bad Request",
                               "{\"error\":\"bad_request_line\"}", false);
    c->close_after = true;
    return -1;
  }
  std::string method = req_line.substr(0, sp1);
  std::string target = req_line.substr(sp1 + 1, sp2 - sp1 - 1);

  // headers: lowercase keys, "k\tv\n" lines for cheap Python parsing
  std::string headers;
  size_t content_length = 0;
  bool keep = true;
  size_t pos = (line_end == std::string::npos) ? head.size() : line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos) eol = head.size();
    std::string line = head.substr(pos, eol - pos);
    pos = eol + 2;
    size_t colon = line.find(':');
    if (colon == std::string::npos) continue;
    std::string k = line.substr(0, colon);
    for (auto& ch : k) ch = static_cast<char>(tolower(ch));
    size_t vs = colon + 1;
    while (vs < line.size() && line[vs] == ' ') vs++;
    std::string v = line.substr(vs);
    if (k == "content-length") content_length = strtoul(v.c_str(), nullptr, 10);
    if (k == "transfer-encoding") {
      // chunked bodies are not implemented; parsing them as zero-length
      // would desync the connection (request smuggling) — reject hard
      c->wbuf += simple_response(501, "Not Implemented",
                                 "{\"error\":\"chunked_not_supported\"}",
                                 false);
      c->close_after = true;
      return -1;
    }
    if (k == "connection") {
      std::string lv = v;
      for (auto& ch : lv) ch = static_cast<char>(tolower(ch));
      keep = (lv != "close");
    }
    headers += k;
    headers += '\t';
    headers += v;
    headers += '\n';
  }
  if (content_length > s->body_limit) {
    c->wbuf += simple_response(413, "Payload Too Large",
                               "{\"error\":\"payload_too_large\"}", false);
    c->close_after = true;
    return -1;
  }
  size_t total = hdr_end + 4 + content_length;
  if (c->rbuf.size() < total) return 0;

  PendingReq r;
  r.method = std::move(method);
  r.path = std::move(target);
  r.headers = std::move(headers);
  r.body = c->rbuf.substr(hdr_end + 4, content_length);
  r.peer = c->peer;
  c->rbuf.erase(0, total);
  c->close_after = !keep;
  c->in_flight = true;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    r.id = s->next_id++;
    c->current_req = r.id;
    s->req_conn[r.id] = c->fd;
    s->ready.push_back(std::move(r));
  }
  s->cv.notify_one();
  return 1;
}

void flush_writes(Server* s, Conn* c) {
  while (!c->wbuf.empty()) {
    ssize_t n = ::send(c->fd, c->wbuf.data(), c->wbuf.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->wbuf.erase(0, static_cast<size_t>(n));
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      arm(s, c->fd, true);
      return;
    } else {
      close_conn(s, c->fd);
      return;
    }
  }
  if (c->close_after && !c->in_flight) {
    close_conn(s, c->fd);
    return;
  }
  arm(s, c->fd, false);
}

void io_loop(Server* s) {
  epoll_event evs[64];
  while (true) {
    int n = epoll_wait(s->epoll_fd, evs, 64, 200);
    {
      std::lock_guard<std::mutex> lk(s->mu);
      if (s->stopping) break;
    }
    // drain responses from Python
    std::deque<PendingResp> resps;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      resps.swap(s->responses);
    }
    for (auto& r : resps) {
      int fd;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        auto it = s->req_conn.find(r.id);
        if (it == s->req_conn.end()) continue;
        fd = it->second;
        s->req_conn.erase(it);
      }
      auto cit = s->conns.find(fd);
      if (cit == s->conns.end()) continue;
      Conn* c = &cit->second;
      if (c->current_req != r.id) continue;  // stale (conn was reused)
      c->wbuf += r.bytes;
      c->in_flight = false;
      c->close_after = c->close_after || r.close_after;
      flush_writes(s, c);
      // a pipelined request may already be buffered
      auto cit2 = s->conns.find(fd);
      if (cit2 != s->conns.end() && !cit2->second.in_flight) {
        try_parse(s, &cit2->second);
        flush_writes(s, &cit2->second);
      }
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == s->wake_fd) {
        uint64_t junk;
        while (::read(s->wake_fd, &junk, 8) > 0) {
        }
        continue;
      }
      if (fd == s->listen_fd) {
        while (true) {
          sockaddr_in caddr{};
          socklen_t clen = sizeof(caddr);
          int cfd = ::accept(s->listen_fd,
                             reinterpret_cast<sockaddr*>(&caddr), &clen);
          if (cfd < 0) break;
          set_nonblock(cfd);
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
          Conn& nc = s->conns[cfd];
          nc.fd = cfd;
          char ip[INET_ADDRSTRLEN] = {0};
          if (inet_ntop(AF_INET, &caddr.sin_addr, ip, sizeof(ip))) {
            nc.peer = ip;  // per-IP rate limits need the real peer
          }
        }
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn* c = &it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, fd);
        continue;
      }
      if (evs[i].events & EPOLLOUT) flush_writes(s, c);
      if (s->conns.find(fd) == s->conns.end()) continue;
      if (evs[i].events & EPOLLIN) {
        char buf[65536];
        while (true) {
          ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
          if (r > 0) {
            c->rbuf.append(buf, static_cast<size_t>(r));
            if (c->rbuf.size() > s->body_limit + 65536) {
              // runaway input (e.g. streaming garbage while a request is
              // in flight): hard-close, or level-triggered epoll would
              // keep growing rbuf without bound
              close_conn(s, fd);
              break;
            }
          } else if (r == 0) {
            close_conn(s, fd);
            break;
          } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
            break;
          } else {
            close_conn(s, fd);
            break;
          }
        }
        auto it2 = s->conns.find(fd);
        if (it2 == s->conns.end()) continue;
        Conn* c2 = &it2->second;
        if (!c2->in_flight) {
          try_parse(s, c2);
          flush_writes(s, c2);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

struct UcfpHttpReq {
  uint64_t id;
  char* method;
  char* path;
  char* headers;  // "key\tvalue\n" lines, lowercase keys
  uint8_t* body;
  uint32_t body_len;
  char* peer;     // client IP string, may be empty
};

void* ucfp_http_start(const char* host, int port, uint32_t body_limit) {
  Server* s = new Server();
  s->body_limit = body_limit;
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // refuse non-numeric hosts rather than silently binding 0.0.0.0
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0 ||
      ::listen(s->listen_fd, 512) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  set_nonblock(s->listen_fd);
  s->epoll_fd = epoll_create1(0);
  s->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->wake_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->wake_fd, &ev);
  s->io = std::thread(io_loop, s);
  return s;
}

int ucfp_http_port(void* h) { return static_cast<Server*>(h)->port; }

// 1 = request filled in, 0 = timeout, -1 = server stopping.
int ucfp_http_next(void* h, int timeout_ms, UcfpHttpReq* out) {
  Server* s = static_cast<Server*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [&] { return !s->ready.empty() || s->stopping; })) {
    return 0;
  }
  if (s->ready.empty()) return -1;
  PendingReq r = std::move(s->ready.front());
  s->ready.pop_front();
  lk.unlock();
  out->id = r.id;
  out->method = strdup(r.method.c_str());
  out->path = strdup(r.path.c_str());
  out->headers = strdup(r.headers.c_str());
  out->body_len = static_cast<uint32_t>(r.body.size());
  out->body = static_cast<uint8_t*>(malloc(r.body.size() ? r.body.size() : 1));
  memcpy(out->body, r.body.data(), r.body.size());
  out->peer = strdup(r.peer.c_str());
  return 1;
}

void ucfp_http_free_req(UcfpHttpReq* r) {
  free(r->method);
  free(r->path);
  free(r->headers);
  free(r->peer);
  free(r->body);
}

void ucfp_http_respond(void* h, uint64_t id, int status,
                       const char* status_text, const char* headers_blob,
                       const uint8_t* body, uint32_t body_len,
                       int close_after) {
  Server* s = static_cast<Server*>(h);
  char head[512];
  snprintf(head, sizeof(head), "HTTP/1.1 %d %s\r\ncontent-length: %u\r\n"
                               "connection: %s\r\n",
           status, status_text, body_len,
           close_after ? "close" : "keep-alive");
  std::string bytes(head);
  bytes += headers_blob;  // "key: value\r\n" lines from Python
  bytes += "\r\n";
  bytes.append(reinterpret_cast<const char*>(body), body_len);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->responses.push_back({id, std::move(bytes), close_after != 0});
  }
  uint64_t one = 1;
  ssize_t ignored = ::write(s->wake_fd, &one, 8);
  (void)ignored;
}

void ucfp_http_stop(void* h) {
  Server* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stopping = true;
  }
  s->cv.notify_all();
  uint64_t one = 1;
  ssize_t ignored = ::write(s->wake_fd, &one, 8);
  (void)ignored;
  s->io.join();
  for (auto& [fd, c] : s->conns) ::close(fd);
  ::close(s->listen_fd);
  ::close(s->epoll_fd);
  ::close(s->wake_fd);
  delete s;
}

}  // extern "C"
