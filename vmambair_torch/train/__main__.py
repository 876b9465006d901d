"""`python -m vmambair_torch.train -opt <config>.yml [--launcher pytorch]
[--device cuda|cpu]`: the training pipeline, rooted at the working
directory (`cli.train_main`)."""

from ..cli import train_main

if __name__ == "__main__":
    train_main()
