// Child-process spawning with piped stdio for process-monitor actors.
//
// ≙ the reference's lang/process.c (pony_os_process_create/wait/kill —
// fork/exec with nonblocking pipes wired to ASIO, backing
// packages/process's ProcessMonitor actor). Same design: three
// O_NONBLOCK pipes, close-on-exec everywhere, the child execs via
// execve, and the parent learns about exit via waitpid(WNOHANG) polls
// (the host polls at step boundaries, where the reference polls from
// the ASIO loop).

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <spawn.h>
#include <string.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cstdint>

extern char** environ;

extern "C" {

// Spawn argv[0] with argv/envp (NULL-terminated arrays of C strings).
// out_fds receives {stdin_w, stdout_r, stderr_r}, all non-blocking.
// Returns pid or -errno.
int64_t ponyx_os_process_spawn(const char* path, char* const argv[],
                               char* const envp[], int32_t out_fds[3]) {
  int in_pipe[2], out_pipe[2], err_pipe[2];
  if (pipe2(in_pipe, O_CLOEXEC) != 0) return -errno;
  if (pipe2(out_pipe, O_CLOEXEC) != 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    return -errno;
  }
  if (pipe2(err_pipe, O_CLOEXEC) != 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    close(out_pipe[0]); close(out_pipe[1]);
    return -errno;
  }

  posix_spawn_file_actions_t fa;
  posix_spawn_file_actions_init(&fa);
  posix_spawn_file_actions_adddup2(&fa, in_pipe[0], 0);
  posix_spawn_file_actions_adddup2(&fa, out_pipe[1], 1);
  posix_spawn_file_actions_adddup2(&fa, err_pipe[1], 2);

  // Own process group so kill() reaches grandchildren too (a shell that
  // forks instead of execing would otherwise keep the stdio pipes open
  // past the direct child's death).
  posix_spawnattr_t at;
  posix_spawnattr_init(&at);
  posix_spawnattr_setpgroup(&at, 0);
  posix_spawnattr_setflags(&at, POSIX_SPAWN_SETPGROUP);

  pid_t pid = -1;
  int rc = posix_spawn(&pid, path, &fa, &at, argv,
                       envp != nullptr ? envp : environ);
  posix_spawnattr_destroy(&at);
  posix_spawn_file_actions_destroy(&fa);
  close(in_pipe[0]);
  close(out_pipe[1]);
  close(err_pipe[1]);
  if (rc != 0) {
    close(in_pipe[1]); close(out_pipe[0]); close(err_pipe[0]);
    return -rc;
  }
  // Parent ends non-blocking for the ASIO loop.
  const int parent_fds[3] = {in_pipe[1], out_pipe[0], err_pipe[0]};
  for (int fd : parent_fds) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
  }
  out_fds[0] = in_pipe[1];
  out_fds[1] = out_pipe[0];
  out_fds[2] = err_pipe[0];
  return pid;
}

// waitpid(WNOHANG). Returns: -1 still running, exit code 0..255, or
// 256+signum when signalled; other -errno on error.
// ≙ pony_os_process_wait (lang/process.c).
int32_t ponyx_os_process_check(int64_t pid) {
  int status = 0;
  pid_t r = waitpid(pid_t(pid), &status, WNOHANG);
  if (r == 0) return -1;
  if (r < 0) return errno == ECHILD ? -ECHILD : -errno;
  if (WIFEXITED(status)) return WEXITSTATUS(status);
  if (WIFSIGNALED(status)) return 256 + WTERMSIG(status);
  return -1;
}

// ≙ pony_os_process_kill — signals the child's whole process group
// (it was spawned as a group leader), falling back to the pid alone.
int32_t ponyx_os_process_kill(int64_t pid, int32_t signum) {
  if (kill(-pid_t(pid), signum) == 0) return 0;
  if (kill(pid_t(pid), signum) != 0) return -errno;
  return 0;
}

}  // extern "C"
