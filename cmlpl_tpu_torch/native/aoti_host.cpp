// cmlpl-aoti-host: native serving runtime for exported scene predictors
// (the counterpart of cmlpl_tpu/native/pjrt_host.cc).
//
// A standalone binary linked against libtorch, with no Python: it loads a
// bundle's AOTInductor package once and runs it many times.  The bundle is
// written by `python -m cmlpl_tpu_torch.cli.export_model --native_dir DIR`
// (utils/export.save_native_bundle):
//
//   model.pt2       AOTInductor package, weights baked in, compiled for one
//                   platform (cuda or cpu)
//   signature.txt   "input|output <name> <f32|i32|bf16|u8|u32> <dims|->",
//                   one line an argument: padded_cube, spectra -> labels
//                   (a training bundle: the state, scene and schedule ->
//                   the final state and the metrics)
//   meta.json       the artifact's metadata; the runner reads its
//                   "platforms" (the default --device), "compute_dtype"
//                   and "custom_ops" (the operators the package calls by
//                   name, which no libtorch has: a training bundle with a
//                   kernel gather holds cmlpl::gather_patches_f32 or _bf16)
//
// A bundle whose meta names custom_ops runs only with --op_library LIB,
// the library that registers them (ops/_build.op_library, built from
// csrc/gather_ops.cpp): it is loaded before the package, and the runner
// fails, naming what is missing, where it cannot be loaded or leaves an
// operator unregistered.  No operator ever falls back to another gather.
//
// Usage:
//   aoti_host --bundle DIR --cube C.npy --spectra S.npy --out O.npy
//       [--repeat N] [--device cuda|cpu]
//     prints one JSON line: load_ms, run_ms_min, run_ms_mean, repeat
//   aoti_host --bundle DIR --inputs IN --outdir OUT [--repeat N]
//       [--device cuda|cpu] [--op_library LIB]
//     the N-ary mode of a training bundle (utils/export.save_run_bundle):
//     reads IN/<name>.npy for every signature input, runs the package,
//     writes OUT/<name>.npy for every output; prints one JSON line:
//     load_ms, run_ms_min, run_ms_mean, repeat, num_inputs, num_outputs
//     (a run: every input's upload to every output's copy back)
//   aoti_host --bundle DIR --serve [--device cuda|cpu]
//     reads requests from stdin, one a line, "cube.npy spectra.npy out.npy",
//     and answers "ok <out> <ms>" or "error <msg>", one line each; the
//     package stays loaded between requests, a bad request never ends the
//     server, and a blank line or EOF does
//   aoti_host --dump_signature DIR     parse DIR/signature.txt, print it
//   aoti_host --npy_roundtrip IN OUT   read IN (.npy), write it to OUT
//
// A run is timed from the inputs' copy to the device to the labels' copy
// back to the host, so no unfinished device work counts as done.  The TF32
// switches of cuDNN and cuBLAS are set from the compute dtype before the
// first run, as the Python side's compute_precision sets them: an f32
// bundle computes in f32.
#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>
#include <dlfcn.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// Thrown for any failure; fatal at top level, but caught per request in
// --serve mode so one bad request cannot end the warm server.
[[noreturn]] void Die(const std::string& what) {
  throw std::runtime_error(what);
}

double MsSince(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

// ---------------------------------------------------------------- npy I/O
// Minimal NumPy .npy v1.0/v2.0 reader and writer for C-order little-endian
// arrays: the only formats the Python side writes.

struct Npy {
  std::string dtype;  // "<f4" | "<i4" | "<u4" | "|u1"
  std::vector<int64_t> shape;
  std::vector<char> data;
  int64_t elems() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return n;
  }
};

Npy ReadNpy(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  char magic[8];
  f.read(magic, 8);
  if (!f || memcmp(magic, "\x93NUMPY", 6) != 0) Die(path + ": not .npy");
  uint32_t hlen = 0;
  if (magic[6] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(header.data(), hlen);
  if (!f) Die(path + ": truncated header");

  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) Die(path + ": header missing " + key);
    p = header.find(':', p);
    return header.substr(p + 1);
  };
  std::string descr = find_val("descr");
  size_t q0 = descr.find('\'');
  size_t q1 = descr.find('\'', q0 + 1);
  Npy out;
  out.dtype = descr.substr(q0 + 1, q1 - q0 - 1);
  if (out.dtype == "<u1") out.dtype = "|u1";
  if (out.dtype != "<f4" && out.dtype != "<i4" && out.dtype != "<u4" &&
      out.dtype != "|u1")
    Die(path + ": unsupported dtype " + out.dtype);
  if (find_val("fortran_order").find("True") != std::string::npos)
    Die(path + ": fortran_order unsupported");
  std::string shp = find_val("shape");
  size_t l = shp.find('('), r = shp.find(')');
  std::stringstream ss(shp.substr(l + 1, r - l - 1));
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    if (tok.find_first_of("0123456789") == std::string::npos) continue;
    out.shape.push_back(std::stoll(tok));
  }
  size_t itemsize = std::stoul(out.dtype.substr(2));
  out.data.resize(out.elems() * itemsize);
  f.read(out.data.data(), out.data.size());
  if (!f) Die(path + ": truncated data");
  return out;
}

void WriteNpy(const std::string& path, const std::string& dtype,
              const std::vector<int64_t>& shape, const void* data,
              size_t nbytes) {
  std::ostringstream hd;
  hd << "{'descr': '" << dtype << "', 'fortran_order': False, 'shape': (";
  for (size_t i = 0; i < shape.size(); ++i) hd << shape[i] << ", ";
  hd << "), }";
  std::string h = hd.str();
  size_t total = 10 + h.size() + 1;
  h += std::string((64 - total % 64) % 64, ' ');
  h += '\n';
  uint16_t hlen = static_cast<uint16_t>(h.size());
  std::ofstream f(path, std::ios::binary);
  if (!f) Die("cannot write " + path);
  f.write("\x93NUMPY\x01\x00", 8);
  f.write(reinterpret_cast<char*>(&hlen), 2);
  f.write(h.data(), h.size());
  f.write(static_cast<const char*>(data), nbytes);
  if (!f) Die("write failed: " + path);
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// The first string in the value of "key" of a JSON text: "platforms":
// ["cuda"] gives cuda, "compute_dtype": "float32" gives float32; "" when
// the key is absent.  meta.json is written by json.dump, and these two
// values are plain words.
std::string JsonWord(const std::string& text, const std::string& key) {
  size_t p = text.find("\"" + key + "\"");
  if (p == std::string::npos) return "";
  p = text.find(':', p);
  size_t q0 = text.find('"', p);
  size_t q1 = text.find('"', q0 + 1);
  if (p == std::string::npos || q0 == std::string::npos ||
      q1 == std::string::npos)
    return "";
  return text.substr(q0 + 1, q1 - q0 - 1);
}

// Every string of the list value of "key" ("custom_ops": ["cmlpl::a",
// "cmlpl::b"] gives both); none when the key is absent or its list empty.
std::vector<std::string> JsonWords(const std::string& text,
                                   const std::string& key) {
  std::vector<std::string> words;
  size_t p = text.find("\"" + key + "\"");
  if (p == std::string::npos) return words;
  size_t l = text.find('[', p);
  size_t r = text.find(']', l);
  if (l == std::string::npos || r == std::string::npos) return words;
  for (size_t q0 = text.find('"', l); q0 < r;
       q0 = text.find('"', text.find('"', q0 + 1) + 1))
    words.push_back(text.substr(q0 + 1, text.find('"', q0 + 1) - q0 - 1));
  return words;
}

// Loads the library that registers the bundle's custom operators and
// holds each to be registered.
void LoadOpLibrary(const std::vector<std::string>& ops,
                   const std::string& library) {
  if (ops.empty()) return;
  std::string names;
  for (const std::string& op : ops) names += (names.empty() ? "" : ", ") + op;
  if (library.empty())
    Die("the bundle calls " + names + ": pass --op_library, the library "
        "that registers them (cmlpl_tpu_torch.ops._build.op_library)");
  if (dlopen(library.c_str(), RTLD_NOW | RTLD_GLOBAL) == nullptr)
    Die("cannot load --op_library " + library + ": " + dlerror());
  for (const std::string& op : ops)
    if (!c10::Dispatcher::singleton().findSchema({op, ""}).has_value())
      Die("--op_library " + library + " registers no " + op);
}

// ------------------------------------------------------------- signature

struct ArgSpec {
  std::string name;
  std::string dtype;  // f32 | i32 | bf16 | u8 | u32
  std::vector<int64_t> dims;
};

struct Signature {
  std::vector<ArgSpec> inputs;
  std::vector<ArgSpec> outputs;
};

Signature ParseSignature(const std::string& path) {
  std::ifstream f(path);
  if (!f) Die("cannot open " + path);
  Signature sig;
  std::string kind, name, dtype, dims;
  while (f >> kind >> name >> dtype >> dims) {
    ArgSpec a;
    a.name = name;
    a.dtype = dtype;
    if (dims != "-") {  // "-" = rank-0 scalar
      std::stringstream ss(dims);
      std::string tok;
      while (std::getline(ss, tok, ','))
        if (!tok.empty()) a.dims.push_back(std::stoll(tok));
    }
    if (kind == "input") sig.inputs.push_back(a);
    else if (kind == "output") sig.outputs.push_back(a);
    else Die(path + ": bad line kind " + kind);
  }
  if (sig.inputs.empty() || sig.outputs.empty())
    Die(path + ": needs >=1 input and output");
  return sig;
}

at::ScalarType DtypeToTorch(const std::string& d) {
  if (d == "f32") return at::kFloat;
  if (d == "i32") return at::kInt;
  if (d == "u32") return at::kUInt32;
  if (d == "bf16") return at::kBFloat16;
  if (d == "u8") return at::kByte;
  Die("unsupported dtype " + d);
}

const char* DtypeToNpy(const std::string& d) {
  if (d == "f32") return "<f4";
  if (d == "i32") return "<i4";
  if (d == "u32") return "<u4";
  if (d == "u8") return "|u1";
  Die("no npy mapping for dtype " + d);
}

std::string Dims(const std::vector<int64_t>& dims) {
  std::string s;
  for (size_t j = 0; j < dims.size(); ++j)
    s += (j ? "," : "") + std::to_string(dims[j]);
  return s.empty() ? "-" : s;
}

// Loads the request's inputs and holds them to the signature.
std::vector<Npy> LoadInputs(const Signature& sig,
                            const std::vector<std::string>& paths) {
  if (paths.size() != sig.inputs.size())
    Die("expected " + std::to_string(sig.inputs.size()) + " inputs, got " +
        std::to_string(paths.size()));
  std::vector<Npy> arrs;
  for (size_t i = 0; i < paths.size(); ++i) {
    Npy a = ReadNpy(paths[i]);
    const ArgSpec& spec = sig.inputs[i];
    if (a.dtype != DtypeToNpy(spec.dtype))
      Die(paths[i] + ": dtype " + a.dtype + ", signature wants " +
          spec.dtype);
    if (a.shape != spec.dims)
      Die(paths[i] + ": shape " + Dims(a.shape) + ", signature wants " +
          Dims(spec.dims) + " for " + spec.name);
    arrs.push_back(std::move(a));
  }
  return arrs;
}

// ------------------------------------------------------------------ host

struct Host {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  at::Device device = at::kCPU;
  Signature sig;

  // Runs the package on the inputs; returns every output on the host, each
  // held to the signature, and the milliseconds from the inputs' upload to
  // the last output's copy back.
  std::pair<std::vector<at::Tensor>, double> RunAll(
      std::vector<Npy>& inputs) {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> args;
    for (size_t i = 0; i < inputs.size(); ++i) {
      const ArgSpec& spec = sig.inputs[i];
      at::Tensor host = at::from_blob(
          inputs[i].data.data(), spec.dims,
          at::TensorOptions().dtype(DtypeToTorch(spec.dtype)));
      args.push_back(host.to(device));
    }
    std::vector<at::Tensor> outs = loader->run(args);
    if (outs.size() != sig.outputs.size())
      Die("package gave " + std::to_string(outs.size()) +
          " outputs, signature wants " +
          std::to_string(sig.outputs.size()));
    for (at::Tensor& out : outs) out = out.to(at::kCPU).contiguous();
    double ms = MsSince(t0);
    for (size_t i = 0; i < outs.size(); ++i) {
      const ArgSpec& ospec = sig.outputs[i];
      if (outs[i].scalar_type() != DtypeToTorch(ospec.dtype) ||
          outs[i].sizes().vec() != ospec.dims)
        Die("package output " + ospec.name + " " +
            std::string(c10::toString(outs[i].scalar_type())) + " " +
            Dims(outs[i].sizes().vec()) + ", signature wants " +
            ospec.dtype + " " + Dims(ospec.dims));
    }
    return {outs, ms};
  }

  std::pair<at::Tensor, double> Run(std::vector<Npy>& inputs) {
    auto [outs, ms] = RunAll(inputs);
    return {outs[0], ms};
  }

  void Write(const at::Tensor& out, const ArgSpec& spec,
             const std::string& path) {
    WriteNpy(path, DtypeToNpy(spec.dtype), spec.dims, out.data_ptr(),
             out.nbytes());
  }

  double RunTo(std::vector<Npy>& inputs, const std::string& out_path) {
    auto [out, ms] = Run(inputs);
    Write(out, sig.outputs[0], out_path);
    return ms;
  }
};

// One line, so a response stays one line whatever the message holds.
std::string Flat(std::string msg) {
  for (char& ch : msg)
    if (ch == '\n' || ch == '\r') ch = ' ';
  return msg;
}

}  // namespace

static int RunMain(int argc, char** argv);

int main(int argc, char** argv) {
  try {
    return RunMain(argc, argv);
  } catch (const std::exception& e) {
    fprintf(stderr, "aoti_host: %s\n", e.what());
    return 1;
  }
}

static int RunMain(int argc, char** argv) {
  std::string bundle, cube, spectra, out_path, device_name, in_dir, out_dir,
      op_library;
  int repeat = 1;
  bool serve = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (++i >= argc) Die("missing value for " + a);
      return argv[i];
    };
    if (a == "--bundle") bundle = next();
    else if (a == "--cube") cube = next();
    else if (a == "--spectra") spectra = next();
    else if (a == "--out") out_path = next();
    else if (a == "--repeat") repeat = std::stoi(next());
    else if (a == "--device") device_name = next();
    else if (a == "--serve") serve = true;
    else if (a == "--inputs") in_dir = next();
    else if (a == "--outdir") out_dir = next();
    else if (a == "--op_library") op_library = next();
    else if (a == "--dump_signature") {
      Signature sig = ParseSignature(next() + "/signature.txt");
      for (const ArgSpec& s : sig.inputs)
        printf("input %s %s %s\n", s.name.c_str(), s.dtype.c_str(),
               Dims(s.dims).c_str());
      for (const ArgSpec& s : sig.outputs)
        printf("output %s %s %s\n", s.name.c_str(), s.dtype.c_str(),
               Dims(s.dims).c_str());
      return 0;
    } else if (a == "--npy_roundtrip") {
      std::string in = next();
      std::string out = next();
      Npy arr = ReadNpy(in);
      WriteNpy(out, arr.dtype, arr.shape, arr.data.data(), arr.data.size());
      printf("ok %lld elems\n", (long long)arr.elems());
      return 0;
    } else {
      Die("unknown flag " + a);
    }
  }
  if (bundle.empty() || repeat < 1)
    Die("usage: aoti_host --bundle DIR [--cube C --spectra S --out O "
        "[--repeat N] | --inputs DIR --outdir DIR [--repeat N] | --serve] "
        "[--device cuda|cpu] [--op_library LIB]");

  std::string meta = ReadFile(bundle + "/meta.json");
  std::string platform = JsonWord(meta, "platforms");
  std::string precision = JsonWord(meta, "compute_dtype");
  if (device_name.empty()) device_name = platform.empty() ? "cuda" : platform;
  if (device_name != "cuda" && device_name != "cpu")
    Die("--device must be cuda or cpu, got " + device_name);
  if (device_name == "cuda" && !torch::cuda::is_available())
    Die("--device cuda: CUDA is not available to this libtorch (no card, "
        "or a CPU build); a cpu bundle runs with --device cpu");
  if (!platform.empty() && platform != device_name)
    Die("the bundle was compiled for " + platform + ", not for " +
        device_name);
  if (precision != "float32" && precision != "bfloat16")
    Die(bundle + "/meta.json: compute_dtype '" + precision +
        "', want float32 or bfloat16");
  // f32 means f32: TF32 only where the model computes in bf16
  bool tf32 = precision == "bfloat16";
  at::globalContext().setAllowTF32CuDNN(tf32);
  at::globalContext().setAllowTF32CuBLAS(tf32);

  LoadOpLibrary(JsonWords(meta, "custom_ops"), op_library);

  Host host;
  host.device = device_name == "cuda" ? at::Device(at::kCUDA, 0)
                                      : at::Device(at::kCPU);
  host.sig = ParseSignature(bundle + "/signature.txt");
  auto t0 = std::chrono::steady_clock::now();
  host.loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
      bundle + "/model.pt2");
  double load_ms = MsSince(t0);
  fprintf(stderr, "aoti_host: %s bundle (%s) loaded in %.0f ms\n",
          device_name.c_str(), precision.c_str(), load_ms);

  if (serve) {
    std::string line;
    while (std::getline(std::cin, line)) {
      if (line.empty()) break;
      std::stringstream ss(line);
      std::string c, s, o, extra;
      if (!(ss >> c >> s >> o) || (ss >> extra)) {
        printf("error bad request (want: cube.npy spectra.npy out.npy)\n");
        fflush(stdout);
        continue;
      }
      try {
        auto inputs = LoadInputs(host.sig, {c, s});
        double ms = host.RunTo(inputs, o);
        printf("ok %s %.3f\n", o.c_str(), ms);
      } catch (const std::exception& e) {
        printf("error %s\n", Flat(e.what()).c_str());
      }
      fflush(stdout);
    }
    return 0;
  }

  if (!in_dir.empty() || !out_dir.empty()) {
    if (in_dir.empty() || out_dir.empty())
      Die("--inputs and --outdir go together");
    std::vector<std::string> paths;
    for (const ArgSpec& spec : host.sig.inputs)
      paths.push_back(in_dir + "/" + spec.name + ".npy");
    auto inputs = LoadInputs(host.sig, paths);
    std::vector<at::Tensor> outs;
    double best = 1e30, sum = 0;
    for (int r = 0; r < repeat; ++r) {
      auto [o, ms] = host.RunAll(inputs);
      outs = std::move(o);
      best = best < ms ? best : ms;
      sum += ms;
    }
    for (size_t i = 0; i < outs.size(); ++i)
      host.Write(outs[i], host.sig.outputs[i],
                 out_dir + "/" + host.sig.outputs[i].name + ".npy");
    printf(
        "{\"load_ms\": %.3f, \"run_ms_min\": %.3f, \"run_ms_mean\": %.3f, "
        "\"repeat\": %d, \"num_inputs\": %zu, \"num_outputs\": %zu, "
        "\"device\": \"%s\"}\n",
        load_ms, best, sum / repeat, repeat, inputs.size(), outs.size(),
        device_name.c_str());
    return 0;
  }

  if (cube.empty() || spectra.empty() || out_path.empty())
    Die("one-shot mode needs --cube, --spectra and --out (or --serve)");
  auto inputs = LoadInputs(host.sig, {cube, spectra});
  double best = 1e30, sum = 0;
  for (int r = 0; r < repeat; ++r) {
    double ms = host.RunTo(inputs, out_path);
    best = best < ms ? best : ms;
    sum += ms;
  }
  printf(
      "{\"load_ms\": %.3f, \"run_ms_min\": %.3f, \"run_ms_mean\": %.3f, "
      "\"repeat\": %d, \"device\": \"%s\"}\n",
      load_ms, best, sum / repeat, repeat, device_name.c_str());
  return 0;
}
