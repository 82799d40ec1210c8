// Host runtime primitives: MPMC job queue + thread pool.
//
// Native re-derivation of the reference's L0 utilities
// (include/continuous_clustering/utils/thread_save_queue.hpp,
//  utils/thread_pool.hpp): a mutex+condvar unbounded queue whose shutdown
// wakes all consumers, and a pool whose 0-thread mode degenerates to
// synchronous inline execution (the reference's deterministic mode).
#pragma once

#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

namespace cct {

template <typename T>
class JobQueue {
 public:
  void enqueue(T&& job) {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      jobs_.push_back(std::move(job));
    }
    cv_.notify_one();
  }

  // Blocks until a job is available or shutdown; nullopt on shutdown+empty.
  std::optional<T> dequeue() {
    std::unique_lock<std::mutex> lock(mutex_);
    cv_.wait(lock, [&] { return shutdown_ || !jobs_.empty(); });
    if (jobs_.empty()) return std::nullopt;
    T job = std::move(jobs_.front());
    jobs_.pop_front();
    return job;
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      shutdown_ = true;
    }
    cv_.notify_all();
  }

  void reset() {
    std::lock_guard<std::mutex> lock(mutex_);
    jobs_.clear();
    shutdown_ = false;
  }

  size_t size() const {
    std::lock_guard<std::mutex> lock(mutex_);
    return jobs_.size();
  }

 private:
  mutable std::mutex mutex_;
  std::condition_variable cv_;
  std::deque<T> jobs_;
  bool shutdown_ = false;
};

template <typename T>
class ThreadPool {
 public:
  using Fn = std::function<void(T&&)>;

  void init(Fn fn, int num_threads) {
    shutdown();
    fn_ = std::move(fn);
    sequential_ = num_threads == 0;
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] {
        while (auto job = queue_.dequeue()) fn_(std::move(*job));
      });
    }
  }

  void enqueue(T&& job) {
    if (sequential_) {
      fn_(std::move(job));
    } else {
      queue_.enqueue(std::move(job));
    }
  }

  size_t pending() const { return queue_.size(); }

  void shutdown() {
    queue_.shutdown();
    for (auto& w : workers_) w.join();
    workers_.clear();
    queue_.reset();
  }

  ~ThreadPool() { shutdown(); }

 private:
  JobQueue<T> queue_;
  std::vector<std::thread> workers_;
  Fn fn_;
  bool sequential_ = true;
};

}  // namespace cct
