"""``python -m dbot_ros_tpu_torch`` — record, track and simulate."""

import sys

from dbot_ros_tpu_torch.runtime.cli import main

if __name__ == "__main__":
    sys.exit(main())
