"""``python -m horovod_tpu_torch.run``: the port's launcher (the
counterpart of ``bin/tpurun`` → ``horovod_tpu.run.run.main``)."""

from .run import main

if __name__ == "__main__":
    main()
