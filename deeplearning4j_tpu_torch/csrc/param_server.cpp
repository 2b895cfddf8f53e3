// Native parameter-server transport core: the host-side push/pull
// aggregation plane of parallel/native_ps.py (the reference's Aeron-based
// VoidParameterServer / RoutedTransport role; the port's own copy of the
// JAX package's native/param_server.cpp, same C interface and wire format).
//
// The compute stays on the device (each worker's train steps); this store
// lets N worker threads and remote peers push large flattened parameter
// vectors concurrently without holding the Python GIL during aggregation or
// socket IO.
//
//   - in-process API: ps_push / ps_pull operate on the shared store directly
//     (lock-guarded soft-sync running average: p += alpha * (v - p))
//   - TCP API: a listener thread accepts connections; protocol is
//     1-byte opcode ('P' push, 'G' get, 'Q' quit) + u64 little-endian byte
//     length + raw little-endian f32 payload. 'G' answers with an 'R' frame
//     in the same framing. Malformed or mis-sized frames close the
//     connection (rejected before any allocation, so a hostile peer cannot
//     force large buffers); well-formed pushes are fire-and-forget.
//
// Build: parallel/native_ps.py runs g++ on first use into the repository's
// build/ directory (g++ -O2 -std=c++17 -fPIC -pthread -shared).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct PsStore {
    std::mutex mu;
    std::vector<float> params;
    double alpha = 1.0;
    std::atomic<int64_t> pushes{0};

    void push(const float* v, int64_t n) {
        if (n != (int64_t)params.size()) return;  // drop mis-sized frame
        std::lock_guard<std::mutex> lk(mu);
        const float a = (float)alpha;
        float* p = params.data();
        for (int64_t i = 0; i < n; ++i) p[i] += a * (v[i] - p[i]);
        pushes.fetch_add(1, std::memory_order_relaxed);
    }

    void pull(float* out, int64_t n) {
        if (n != (int64_t)params.size()) return;
        std::lock_guard<std::mutex> lk(mu);
        std::memcpy(out, params.data(), sizeof(float) * (size_t)n);
    }
};

struct PsServer {
    PsStore store;
    int listen_fd = -1;
    int port = 0;
    std::atomic<bool> stop{false};
    std::thread acceptor;
    std::mutex conn_mu;
    std::vector<int> conn_fds;        // open connections (handlers detached)
    std::atomic<int> active{0};

    ~PsServer() { shutdown(); }

    void add_conn(int fd) {
        std::lock_guard<std::mutex> lk(conn_mu);
        conn_fds.push_back(fd);
        active.fetch_add(1);
    }

    void remove_conn(int fd) {
        {
            std::lock_guard<std::mutex> lk(conn_mu);
            for (auto it = conn_fds.begin(); it != conn_fds.end(); ++it)
                if (*it == fd) { conn_fds.erase(it); break; }
        }
        active.fetch_sub(1);
    }

    void shutdown() {
        bool expected = false;
        if (!stop.compare_exchange_strong(expected, true)) return;
        if (listen_fd >= 0) { ::shutdown(listen_fd, SHUT_RDWR); ::close(listen_fd); }
        if (acceptor.joinable()) acceptor.join();   // no new connections now
        {
            // force handlers out of blocking recv()/send(): after SHUT_RDWR
            // every socket call returns promptly, so each detached handler
            // reaches its exit path in bounded time
            std::lock_guard<std::mutex> lk(conn_mu);
            for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
        }
        // wait until every handler has exited — must be unbounded: a timed
        // wait would let ~PsServer free this object under a live handler
        // (use-after-free). Progress is guaranteed by the SHUT_RDWR above.
        while (active.load() > 0)
            std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
};

bool recv_exact(int fd, void* buf, size_t n) {
    char* p = (char*)buf;
    while (n) {
        ssize_t r = ::recv(fd, p, n, 0);
        if (r <= 0) return false;
        p += r;
        n -= (size_t)r;
    }
    return true;
}

bool send_all(int fd, const void* buf, size_t n) {
    const char* p = (const char*)buf;
    while (n) {
        ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
        if (r <= 0) return false;
        p += r;
        n -= (size_t)r;
    }
    return true;
}

void handle_conn(PsServer* srv, int fd) {
    std::vector<float> scratch;
    for (;;) {
        char op;
        uint64_t len;
        if (!recv_exact(fd, &op, 1) || !recv_exact(fd, &len, 8)) break;
        if (op == 'Q') break;
        if (op == 'P') {
            // The parameter vector size is fixed at ps_create: reject any
            // other length BEFORE allocating — a loopback client could
            // otherwise force multi-GiB scratch allocations, and a
            // bad_alloc thrown in this detached handler thread would
            // std::terminate the whole host process.
            if (len != (uint64_t)srv->store.params.size() * 4) break;
            scratch.resize(len / 4);
            if (!recv_exact(fd, scratch.data(), len)) break;
            srv->store.push(scratch.data(), (int64_t)(len / 4));
        } else if (op == 'G') {
            if (len != 0) break;
            std::vector<float> out(srv->store.params.size());
            srv->store.pull(out.data(), (int64_t)out.size());
            char rop = 'R';
            uint64_t rlen = (uint64_t)out.size() * 4;
            if (!send_all(fd, &rop, 1) || !send_all(fd, &rlen, 8) ||
                !send_all(fd, out.data(), rlen))
                break;
        } else {
            break;  // unknown op: drop connection (stream no longer framed)
        }
    }
    // deregister BEFORE close: once closed, the kernel may reuse this fd
    // number, and shutdown() iterating conn_fds must never hit a stranger
    srv->remove_conn(fd);
    ::close(fd);
}

void accept_loop(PsServer* srv) {
    while (!srv->stop.load()) {
        int fd = ::accept(srv->listen_fd, nullptr, nullptr);
        if (fd < 0) {
            if (srv->stop.load()) break;
            continue;
        }
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        srv->add_conn(fd);
        std::thread(handle_conn, srv, fd).detach();
    }
}

}  // namespace

extern "C" {

// Create a server. port==0 binds an ephemeral port; serve==0 skips the TCP
// listener (pure in-process store). Returns opaque handle or null.
void* ps_create(const float* initial, int64_t n, double alpha, int port,
                int serve) {
    auto* srv = new PsServer();
    srv->store.params.assign(initial, initial + n);
    srv->store.alpha = alpha;
    if (serve) {
        srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
        if (srv->listen_fd < 0) { delete srv; return nullptr; }
        int one = 1;
        ::setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one,
                     sizeof(one));
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
        addr.sin_port = htons((uint16_t)port);
        if (::bind(srv->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
            ::listen(srv->listen_fd, 64) < 0) {
            ::close(srv->listen_fd);
            delete srv;
            return nullptr;
        }
        socklen_t alen = sizeof(addr);
        ::getsockname(srv->listen_fd, (sockaddr*)&addr, &alen);
        srv->port = ntohs(addr.sin_port);
        srv->acceptor = std::thread(accept_loop, srv);
    }
    return srv;
}

int ps_port(void* h) { return ((PsServer*)h)->port; }

void ps_push(void* h, const float* v, int64_t n) {
    ((PsServer*)h)->store.push(v, n);
}

void ps_pull(void* h, float* out, int64_t n) {
    ((PsServer*)h)->store.pull(out, n);
}

int64_t ps_pushes(void* h) {
    return ((PsServer*)h)->store.pushes.load();
}

void ps_destroy(void* h) { delete (PsServer*)h; }

}  // extern "C"
