from fedml_tpu_torch.experiments.main import main

if __name__ == "__main__":
    main()
