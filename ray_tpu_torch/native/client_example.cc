// C++ client round-trip example/driver of the port's object store (also a
// template for native data loaders).
//
//   client_example <store_name> put <object_id_hex> <payload>
//   client_example <store_name> get <object_id_hex>
//
// Build: `python -m ray_tpu_torch.native.build` (native/build.py
// build_binary("client_example"): g++ -O2 -std=c++17, linked against the
// exact libshm_store-<hash>.so that lib_path("libshm_store.so") returns,
// with an rpath to .build/ray_tpu_torch/native/).

#include <cstdio>
#include <string>

#include "ray_tpu_client.h"

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <store> put <id_hex> <payload> | get <id_hex>\n",
                 argv[0]);
    return 2;
  }
  try {
    raytpu::ObjectStoreClient client(argv[1]);
    raytpu::ObjectId id = raytpu::ObjectId::FromHex(argv[3]);
    std::string cmd = argv[2];
    if (cmd == "put") {
      client.Put(id, std::string(argv[4]));
      std::printf("put %s (%zu bytes)\n", id.Hex().c_str(),
                  std::string(argv[4]).size());
    } else if (cmd == "get") {
      raytpu::ObjectBuffer buf = client.Get(id);
      std::printf("get %s -> %llu bytes: %s\n", id.Hex().c_str(),
                  static_cast<unsigned long long>(buf.size()),
                  buf.ToString().c_str());
    } else {
      std::fprintf(stderr, "unknown command %s\n", cmd.c_str());
      return 2;
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
  return 0;
}
