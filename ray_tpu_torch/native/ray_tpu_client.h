// ray_tpu_torch C++ client: native access to a node's shared-memory object store.
//
// Ref analog: the reference's C++ worker API (cpp/include/ray/api.h) lets
// native code produce/consume objects in the plasma store. The port's
// equivalent is data-plane interop: a C++ process on a node attaches to
// that node's arena (created by the Python runtime) and reads/writes
// objects zero-copy — e.g. a native data loader feeding a Python/PyTorch
// training job, or a C++ consumer of task results. Task/actor submission
// stays in Python (tasks are Python functions); this header is the
// native data plane, not a native task runtime.
//
// Link against the port's libshm_store (built by
// `python -m ray_tpu_torch.native.build` into
// .build/ray_tpu_torch/native/libshm_store-<hash>.so; native/build.py
// lib_path("libshm_store.so") returns the file, and
// build_binary("client_example") links this header's example to it).
// Object IDs are 20 raw bytes —
// obtain them from Python (`ref.id.binary()`) or mint client-local ones
// with raytpu::ObjectId::Random() for native<->native use.
//
// Payload convention for cross-language objects: RAW BYTES with empty
// metadata (meta_size == 0). Python reads them with
// `ShmObjectStore.get_raw(oid)` and writes them with
// `ShmObjectStore.put_raw(oid, data)`; pickled Python objects carry a
// non-empty metadata suffix and are NOT generally decodable from C++.

#ifndef RAY_TPU_CLIENT_H_
#define RAY_TPU_CLIENT_H_

#include <cstdint>
#include <cstring>
#include <random>
#include <stdexcept>
#include <string>

extern "C" {
void* shm_store_attach(const char* name);
void shm_store_detach(void* handle);
// Returns arena offset (>0), 0 = full, -1 = already exists.
int64_t shm_store_create_object(void* handle, const uint8_t* id,
                                uint64_t data_size, uint64_t meta_size);
int shm_store_seal(void* handle, const uint8_t* id);
// out = {offset, data_size, meta_size}; pins the object. 0 on success.
int shm_store_get(void* handle, const uint8_t* id, uint64_t* out);
int shm_store_contains(void* handle, const uint8_t* id);
int shm_store_release(void* handle, const uint8_t* id);
int shm_store_delete(void* handle, const uint8_t* id);
uint64_t shm_store_bytes_in_use(void* handle);
uint64_t shm_store_capacity(void* handle);
void* shm_store_base_ptr(void* handle);
}

namespace raytpu {

constexpr int kIdSize = 20;

struct ObjectId {
  uint8_t bytes[kIdSize];

  static ObjectId Random() {
    ObjectId id;
    std::random_device rd;
    for (int i = 0; i < kIdSize; i++) id.bytes[i] = rd() & 0xff;
    return id;
  }

  static ObjectId FromBinary(const std::string& bin) {
    if (bin.size() != kIdSize)
      throw std::invalid_argument("ObjectId needs exactly 20 bytes");
    ObjectId id;
    std::memcpy(id.bytes, bin.data(), kIdSize);
    return id;
  }

  static ObjectId FromHex(const std::string& hex) {
    if (hex.size() != 2 * kIdSize)
      throw std::invalid_argument("ObjectId hex needs 40 chars");
    ObjectId id;
    for (int i = 0; i < kIdSize; i++)
      id.bytes[i] = static_cast<uint8_t>(
          std::stoi(hex.substr(2 * i, 2), nullptr, 16));
    return id;
  }

  std::string Hex() const {
    static const char* d = "0123456789abcdef";
    std::string out(2 * kIdSize, '0');
    for (int i = 0; i < kIdSize; i++) {
      out[2 * i] = d[bytes[i] >> 4];
      out[2 * i + 1] = d[bytes[i] & 0xf];
    }
    return out;
  }

  const uint8_t* data() const { return bytes; }
};

// A pinned, zero-copy view of an object's payload; releases the pin on
// destruction.
class ObjectBuffer {
 public:
  ObjectBuffer(void* store, ObjectId id, const uint8_t* data, uint64_t size)
      : store_(store), id_(id), data_(data), size_(size) {}
  ObjectBuffer(const ObjectBuffer&) = delete;
  ObjectBuffer& operator=(const ObjectBuffer&) = delete;
  ObjectBuffer(ObjectBuffer&& o) noexcept
      : store_(o.store_), id_(o.id_), data_(o.data_), size_(o.size_) {
    o.store_ = nullptr;
  }
  ~ObjectBuffer() {
    if (store_) shm_store_release(store_, id_.data());
  }
  const uint8_t* data() const { return data_; }
  uint64_t size() const { return size_; }
  std::string ToString() const {
    return std::string(reinterpret_cast<const char*>(data_), size_);
  }

 private:
  void* store_;
  ObjectId id_;
  const uint8_t* data_;
  uint64_t size_;
};

class ObjectStoreClient {
 public:
  // `store_name` is the node's arena name — Python exposes it as
  // `ray_tpu_torch.nodes()[i]["store_name"]`.
  explicit ObjectStoreClient(const std::string& store_name) {
    handle_ = shm_store_attach(store_name.c_str());
    if (!handle_)
      throw std::runtime_error("cannot attach to store '" + store_name +
                               "' (is the runtime up on this node?)");
    base_ = static_cast<uint8_t*>(shm_store_base_ptr(handle_));
  }
  ~ObjectStoreClient() {
    if (handle_) shm_store_detach(handle_);
  }
  ObjectStoreClient(const ObjectStoreClient&) = delete;
  ObjectStoreClient& operator=(const ObjectStoreClient&) = delete;

  // Store raw bytes under `id` (cross-language convention: no metadata).
  void Put(const ObjectId& id, const void* data, uint64_t size) {
    int64_t off = shm_store_create_object(handle_, id.data(), size, 0);
    if (off == -1) throw std::runtime_error("object already exists");
    if (off == 0) throw std::runtime_error("object store is full");
    std::memcpy(base_ + off, data, size);
    if (shm_store_seal(handle_, id.data()) != 0)
      throw std::runtime_error("seal failed");
  }
  void Put(const ObjectId& id, const std::string& s) {
    Put(id, s.data(), s.size());
  }

  bool Contains(const ObjectId& id) const {
    return shm_store_contains(handle_, id.data()) == 1;
  }

  // Zero-copy pinned view (data + metadata contiguous; size excludes
  // metadata for raw-convention objects, which have none).
  ObjectBuffer Get(const ObjectId& id) const {
    uint64_t out[3];
    if (shm_store_get(handle_, id.data(), out) != 0)
      throw std::runtime_error("object not found: " + id.Hex());
    return ObjectBuffer(handle_, id, base_ + out[0], out[1]);
  }

  bool Delete(const ObjectId& id) {
    return shm_store_delete(handle_, id.data()) == 0;
  }

  uint64_t BytesInUse() const { return shm_store_bytes_in_use(handle_); }
  uint64_t Capacity() const { return shm_store_capacity(handle_); }

 private:
  void* handle_ = nullptr;
  uint8_t* base_ = nullptr;
};

}  // namespace raytpu

#endif  // RAY_TPU_CLIENT_H_
