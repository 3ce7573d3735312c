# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: kserve_v2.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fkserve_v2.proto\x12\tinference\"\x13\n\x11ServerLiveRequest\"\"\n\x12ServerLiveResponse\x12\x0c\n\x04live\x18\x01 \x01(\x08\"\x14\n\x12ServerReadyRequest\"$\n\x13ServerReadyResponse\x12\r\n\x05ready\x18\x01 \x01(\x08\"2\n\x11ModelReadyRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"#\n\x12ModelReadyResponse\x12\r\n\x05ready\x18\x01 \x01(\x08\"\x17\n\x15ServerMetadataRequest\"K\n\x16ServerMetadataResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x12\n\nextensions\x18\x03 \x03(\t\"5\n\x14ModelMetadataRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"\x8d\x02\n\x15ModelMetadataResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08versions\x18\x02 \x03(\t\x12\x10\n\x08platform\x18\x03 \x01(\t\x12?\n\x06inputs\x18\x04 \x03(\x0b\x32/.inference.ModelMetadataResponse.TensorMetadata\x12@\n\x07outputs\x18\x05 \x03(\x0b\x32/.inference.ModelMetadataResponse.TensorMetadata\x1a?\n\x0eTensorMetadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\"\x99\x01\n\x0eInferParameter\x12\x14\n\nbool_param\x18\x01 \x01(\x08H\x00\x12\x15\n\x0bint64_param\x18\x02 \x01(\x03H\x00\x12\x16\n\x0cstring_param\x18\x03 \x01(\tH\x00\x12\x16\n\x0c\x64ouble_param\x18\x04 \x01(\x01H\x00\x12\x16\n\x0cuint64_param\x18\x05 \x01(\x04H\x00\x42\x12\n\x10parameter_choice\"\xd0\x01\n\x13InferTensorContents\x12\x15\n\rbool_contents\x18\x01 \x03(\x08\x12\x14\n\x0cint_contents\x18\x02 \x03(\x05\x12\x16\n\x0eint64_contents\x18\x03 \x03(\x03\x12\x15\n\ruint_contents\x18\x04 \x03(\r\x12\x17\n\x0fuint64_contents\x18\x05 \x03(\x04\x12\x15\n\rfp32_contents\x18\x06 \x03(\x02\x12\x15\n\rfp64_contents\x18\x07 \x03(\x01\x12\x16\n\x0e\x62ytes_contents\x18\x08 \x03(\x0c\"\x86\x07\n\x11ModelInferRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 \x01(\t\x12@\n\nparameters\x18\x04 \x03(\x0b\x32,.inference.ModelInferRequest.ParametersEntry\x12=\n\x06inputs\x18\x05 \x03(\x0b\x32-.inference.ModelInferRequest.InferInputTensor\x12H\n\x07outputs\x18\x06 \x03(\x0b\x32\x37.inference.ModelInferRequest.InferRequestedOutputTensor\x12\x1a\n\x12raw_input_contents\x18\x07 \x03(\x0c\x12\x16\n\x0e\x63lient_send_ms\x18\x08 \x01(\x04\x1a\x94\x02\n\x10InferInputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\x12Q\n\nparameters\x18\x04 \x03(\x0b\x32=.inference.ModelInferRequest.InferInputTensor.ParametersEntry\x12\x30\n\x08\x63ontents\x18\x05 \x01(\x0b\x32\x1e.inference.InferTensorContents\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.InferParameter:\x02\x38\x01\x1a\xd5\x01\n\x1aInferRequestedOutputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12[\n\nparameters\x18\x02 \x03(\x0b\x32G.inference.ModelInferRequest.InferRequestedOutputTensor.ParametersEntry\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.InferParameter:\x02\x38\x01\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.InferParameter:\x02\x38\x01\"\xb7\x07\n\x12ModelInferResponse\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 \x01(\t\x12\x41\n\nparameters\x18\x04 \x03(\x0b\x32-.inference.ModelInferResponse.ParametersEntry\x12@\n\x07outputs\x18\x05 \x03(\x0b\x32/.inference.ModelInferResponse.InferOutputTensor\x12\x1b\n\x13raw_output_contents\x18\x06 \x03(\x0c\x12\x19\n\x11server_receive_ms\x18\x07 \x01(\x04\x12\x16\n\x0eserver_send_ms\x18\x08 \x01(\x04\x12\x17\n\x0fserver_queue_ms\x18\t \x01(\x01\x12\x18\n\x10server_submit_ms\x18\n \x01(\x01\x12\x1c\n\x14server_scheduling_ms\x18\x0b \x01(\x01\x12\x19\n\x11server_codelet_ms\x18\x0c \x01(\x01\x12\x1b\n\x13server_inference_ms\x18\r \x01(\x01\x12\x1a\n\x12server_callback_ms\x18\x0e \x01(\x01\x12\x17\n\x0fserver_total_ms\x18\x0f \x01(\x01\x12\x1c\n\x14server_preprocess_ms\x18\x10 \x01(\x01\x12\x1d\n\x15server_postprocess_ms\x18\x11 \x01(\x01\x12\x19\n\x11server_overall_ms\x18\x12 \x01(\x01\x12\x17\n\x0fserver_batch_ms\x18\x13 \x01(\x01\x1a\x97\x02\n\x11InferOutputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\x12S\n\nparameters\x18\x04 \x03(\x0b\x32?.inference.ModelInferResponse.InferOutputTensor.ParametersEntry\x12\x30\n\x08\x63ontents\x18\x05 \x01(\x0b\x32\x1e.inference.InferTensorContents\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.InferParameter:\x02\x38\x01\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.InferParameter:\x02\x38\x01\"h\n\x18ModelStreamInferResponse\x12\x15\n\rerror_message\x18\x01 \x01(\t\x12\x35\n\x0einfer_response\x18\x02 \x01(\x0b\x32\x1d.inference.ModelInferResponse\"P\n\nModelInput\x12\x0c\n\x04name\x18\x01 \x01(\t\x12&\n\tdata_type\x18\x02 \x01(\x0e\x32\x13.inference.DataType\x12\x0c\n\x04\x64ims\x18\x04 \x03(\x03\"Q\n\x0bModelOutput\x12\x0c\n\x04name\x18\x01 \x01(\t\x12&\n\tdata_type\x18\x02 \x01(\x0e\x32\x13.inference.DataType\x12\x0c\n\x04\x64ims\x18\x03 \x03(\x03\"\x93\x01\n\x0bModelConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x16\n\x0emax_batch_size\x18\x04 \x01(\x05\x12$\n\x05input\x18\x05 \x03(\x0b\x32\x15.inference.ModelInput\x12&\n\x06output\x18\x06 \x03(\x0b\x32\x16.inference.ModelOutput\"3\n\x12ModelConfigRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"=\n\x13ModelConfigResponse\x12&\n\x06\x63onfig\x18\x01 \x01(\x0b\x32\x16.inference.ModelConfig\"7\n\x16ModelStatisticsRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\".\n\x11StatisticDuration\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\n\n\x02ns\x18\x02 \x01(\x04\"\x9c\x03\n\x0fInferStatistics\x12-\n\x07success\x18\x01 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12*\n\x04\x66\x61il\x18\x02 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12+\n\x05queue\x18\x03 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x33\n\rcompute_input\x18\x04 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x33\n\rcompute_infer\x18\x05 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x34\n\x0e\x63ompute_output\x18\x06 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12/\n\tcache_hit\x18\x07 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x30\n\ncache_miss\x18\x08 \x01(\x0b\x32\x1c.inference.StatisticDuration\"\xca\x01\n\x14InferBatchStatistics\x12\x12\n\nbatch_size\x18\x01 \x01(\x04\x12\x33\n\rcompute_input\x18\x02 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x33\n\rcompute_infer\x18\x03 \x01(\x0b\x32\x1c.inference.StatisticDuration\x12\x34\n\x0e\x63ompute_output\x18\x04 \x01(\x0b\x32\x1c.inference.StatisticDuration\"\xe5\x01\n\x0fModelStatistics\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x16\n\x0elast_inference\x18\x03 \x01(\x04\x12\x17\n\x0finference_count\x18\x04 \x01(\x04\x12\x17\n\x0f\x65xecution_count\x18\x05 \x01(\x04\x12\x33\n\x0finference_stats\x18\x06 \x01(\x0b\x32\x1a.inference.InferStatistics\x12\x34\n\x0b\x62\x61tch_stats\x18\x07 \x03(\x0b\x32\x1f.inference.InferBatchStatistics\"J\n\x17ModelStatisticsResponse\x12/\n\x0bmodel_stats\x18\x01 \x03(\x0b\x32\x1a.inference.ModelStatistics\"@\n\x16RepositoryIndexRequest\x12\x17\n\x0frepository_name\x18\x01 \x01(\t\x12\r\n\x05ready\x18\x02 \x01(\x08\"\xa4\x01\n\x17RepositoryIndexResponse\x12=\n\x06models\x18\x01 \x03(\x0b\x32-.inference.RepositoryIndexResponse.ModelIndex\x1aJ\n\nModelIndex\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\r\n\x05state\x18\x03 \x01(\t\x12\x0e\n\x06reason\x18\x04 \x01(\t\"I\n\x1aRepositoryModelLoadRequest\x12\x17\n\x0frepository_name\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\"\x1d\n\x1bRepositoryModelLoadResponse\"K\n\x1cRepositoryModelUnloadRequest\x12\x17\n\x0frepository_name\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\"\x1f\n\x1dRepositoryModelUnloadResponse\"/\n\x1fSystemSharedMemoryStatusRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\xa5\x02\n SystemSharedMemoryStatusResponse\x12I\n\x07regions\x18\x01 \x03(\x0b\x32\x38.inference.SystemSharedMemoryStatusResponse.RegionsEntry\x1aL\n\x0cRegionStatus\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\x11\n\tbyte_size\x18\x04 \x01(\x04\x1ah\n\x0cRegionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12G\n\x05value\x18\x02 \x01(\x0b\x32\x38.inference.SystemSharedMemoryStatusResponse.RegionStatus:\x02\x38\x01\"a\n!SystemSharedMemoryRegisterRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\x11\n\tbyte_size\x18\x04 \x01(\x04\"$\n\"SystemSharedMemoryRegisterResponse\"3\n#SystemSharedMemoryUnregisterRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"&\n$SystemSharedMemoryUnregisterResponse\"-\n\x1d\x43udaSharedMemoryStatusRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x95\x02\n\x1e\x43udaSharedMemoryStatusResponse\x12G\n\x07regions\x18\x01 \x03(\x0b\x32\x36.inference.CudaSharedMemoryStatusResponse.RegionsEntry\x1a\x42\n\x0cRegionStatus\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdevice_id\x18\x02 \x01(\x04\x12\x11\n\tbyte_size\x18\x03 \x01(\x04\x1a\x66\n\x0cRegionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x45\n\x05value\x18\x02 \x01(\x0b\x32\x36.inference.CudaSharedMemoryStatusResponse.RegionStatus:\x02\x38\x01\"i\n\x1f\x43udaSharedMemoryRegisterRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nraw_handle\x18\x02 \x01(\x0c\x12\x11\n\tdevice_id\x18\x03 \x01(\x03\x12\x11\n\tbyte_size\x18\x04 \x01(\x04\"\"\n CudaSharedMemoryRegisterResponse\"1\n!CudaSharedMemoryUnregisterRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"$\n\"CudaSharedMemoryUnregisterResponse\"\xe6\x01\n\x13TraceSettingRequest\x12>\n\x08settings\x18\x01 \x03(\x0b\x32,.inference.TraceSettingRequest.SettingsEntry\x12\x12\n\nmodel_name\x18\x02 \x01(\t\x1a\x1d\n\x0cSettingValue\x12\r\n\x05value\x18\x01 \x03(\t\x1a\\\n\rSettingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12:\n\x05value\x18\x02 \x01(\x0b\x32+.inference.TraceSettingRequest.SettingValue:\x02\x38\x01\"\xd5\x01\n\x14TraceSettingResponse\x12?\n\x08settings\x18\x01 \x03(\x0b\x32-.inference.TraceSettingResponse.SettingsEntry\x1a\x1d\n\x0cSettingValue\x12\r\n\x05value\x18\x01 \x03(\t\x1a]\n\rSettingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12;\n\x05value\x18\x02 \x01(\x0b\x32,.inference.TraceSettingResponse.SettingValue:\x02\x38\x01\"\x9a\x02\n\x12LogSettingsRequest\x12=\n\x08settings\x18\x01 \x03(\x0b\x32+.inference.LogSettingsRequest.SettingsEntry\x1ah\n\x0cSettingValue\x12\x14\n\nbool_param\x18\x01 \x01(\x08H\x00\x12\x16\n\x0cuint32_param\x18\x02 \x01(\rH\x00\x12\x16\n\x0cstring_param\x18\x03 \x01(\tH\x00\x42\x12\n\x10parameter_choice\x1a[\n\rSettingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x39\n\x05value\x18\x02 \x01(\x0b\x32*.inference.LogSettingsRequest.SettingValue:\x02\x38\x01\"\x9d\x02\n\x13LogSettingsResponse\x12>\n\x08settings\x18\x01 \x03(\x0b\x32,.inference.LogSettingsResponse.SettingsEntry\x1ah\n\x0cSettingValue\x12\x14\n\nbool_param\x18\x01 \x01(\x08H\x00\x12\x16\n\x0cuint32_param\x18\x02 \x01(\rH\x00\x12\x16\n\x0cstring_param\x18\x03 \x01(\tH\x00\x42\x12\n\x10parameter_choice\x1a\\\n\rSettingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12:\n\x05value\x18\x02 \x01(\x0b\x32+.inference.LogSettingsResponse.SettingValue:\x02\x38\x01*\xfa\x01\n\x08\x44\x61taType\x12\x10\n\x0cTYPE_INVALID\x10\x00\x12\r\n\tTYPE_BOOL\x10\x01\x12\x0e\n\nTYPE_UINT8\x10\x02\x12\x0f\n\x0bTYPE_UINT16\x10\x03\x12\x0f\n\x0bTYPE_UINT32\x10\x04\x12\x0f\n\x0bTYPE_UINT64\x10\x05\x12\r\n\tTYPE_INT8\x10\x06\x12\x0e\n\nTYPE_INT16\x10\x07\x12\x0e\n\nTYPE_INT32\x10\x08\x12\x0e\n\nTYPE_INT64\x10\t\x12\r\n\tTYPE_FP16\x10\n\x12\r\n\tTYPE_FP32\x10\x0b\x12\r\n\tTYPE_FP64\x10\x0c\x12\x0f\n\x0bTYPE_STRING\x10\r\x12\r\n\tTYPE_BF16\x10\x0e\x32\xb7\x0f\n\x14GRPCInferenceService\x12K\n\nServerLive\x12\x1c.inference.ServerLiveRequest\x1a\x1d.inference.ServerLiveResponse\"\x00\x12N\n\x0bServerReady\x12\x1d.inference.ServerReadyRequest\x1a\x1e.inference.ServerReadyResponse\"\x00\x12K\n\nModelReady\x12\x1c.inference.ModelReadyRequest\x1a\x1d.inference.ModelReadyResponse\"\x00\x12W\n\x0eServerMetadata\x12 .inference.ServerMetadataRequest\x1a!.inference.ServerMetadataResponse\"\x00\x12T\n\rModelMetadata\x12\x1f.inference.ModelMetadataRequest\x1a .inference.ModelMetadataResponse\"\x00\x12K\n\nModelInfer\x12\x1c.inference.ModelInferRequest\x1a\x1d.inference.ModelInferResponse\"\x00\x12[\n\x10ModelStreamInfer\x12\x1c.inference.ModelInferRequest\x1a#.inference.ModelStreamInferResponse\"\x00(\x01\x30\x01\x12N\n\x0bModelConfig\x12\x1d.inference.ModelConfigRequest\x1a\x1e.inference.ModelConfigResponse\"\x00\x12Z\n\x0fModelStatistics\x12!.inference.ModelStatisticsRequest\x1a\".inference.ModelStatisticsResponse\"\x00\x12Z\n\x0fRepositoryIndex\x12!.inference.RepositoryIndexRequest\x1a\".inference.RepositoryIndexResponse\"\x00\x12\x66\n\x13RepositoryModelLoad\x12%.inference.RepositoryModelLoadRequest\x1a&.inference.RepositoryModelLoadResponse\"\x00\x12l\n\x15RepositoryModelUnload\x12\'.inference.RepositoryModelUnloadRequest\x1a(.inference.RepositoryModelUnloadResponse\"\x00\x12u\n\x18SystemSharedMemoryStatus\x12*.inference.SystemSharedMemoryStatusRequest\x1a+.inference.SystemSharedMemoryStatusResponse\"\x00\x12{\n\x1aSystemSharedMemoryRegister\x12,.inference.SystemSharedMemoryRegisterRequest\x1a-.inference.SystemSharedMemoryRegisterResponse\"\x00\x12\x81\x01\n\x1cSystemSharedMemoryUnregister\x12..inference.SystemSharedMemoryUnregisterRequest\x1a/.inference.SystemSharedMemoryUnregisterResponse\"\x00\x12o\n\x16\x43udaSharedMemoryStatus\x12(.inference.CudaSharedMemoryStatusRequest\x1a).inference.CudaSharedMemoryStatusResponse\"\x00\x12u\n\x18\x43udaSharedMemoryRegister\x12*.inference.CudaSharedMemoryRegisterRequest\x1a+.inference.CudaSharedMemoryRegisterResponse\"\x00\x12{\n\x1a\x43udaSharedMemoryUnregister\x12,.inference.CudaSharedMemoryUnregisterRequest\x1a-.inference.CudaSharedMemoryUnregisterResponse\"\x00\x12Q\n\x0cTraceSetting\x12\x1e.inference.TraceSettingRequest\x1a\x1f.inference.TraceSettingResponse\"\x00\x12N\n\x0bLogSettings\x12\x1d.inference.LogSettingsRequest\x1a\x1e.inference.LogSettingsResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'kserve_v2_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELINFERREQUEST_INFERINPUTTENSOR_PARAMETERSENTRY._options = None
  _MODELINFERREQUEST_INFERINPUTTENSOR_PARAMETERSENTRY._serialized_options = b'8\001'
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR_PARAMETERSENTRY._options = None
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR_PARAMETERSENTRY._serialized_options = b'8\001'
  _MODELINFERREQUEST_PARAMETERSENTRY._options = None
  _MODELINFERREQUEST_PARAMETERSENTRY._serialized_options = b'8\001'
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR_PARAMETERSENTRY._options = None
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR_PARAMETERSENTRY._serialized_options = b'8\001'
  _MODELINFERRESPONSE_PARAMETERSENTRY._options = None
  _MODELINFERRESPONSE_PARAMETERSENTRY._serialized_options = b'8\001'
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._options = None
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_options = b'8\001'
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._options = None
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_options = b'8\001'
  _TRACESETTINGREQUEST_SETTINGSENTRY._options = None
  _TRACESETTINGREQUEST_SETTINGSENTRY._serialized_options = b'8\001'
  _TRACESETTINGRESPONSE_SETTINGSENTRY._options = None
  _TRACESETTINGRESPONSE_SETTINGSENTRY._serialized_options = b'8\001'
  _LOGSETTINGSREQUEST_SETTINGSENTRY._options = None
  _LOGSETTINGSREQUEST_SETTINGSENTRY._serialized_options = b'8\001'
  _LOGSETTINGSRESPONSE_SETTINGSENTRY._options = None
  _LOGSETTINGSRESPONSE_SETTINGSENTRY._serialized_options = b'8\001'
  _DATATYPE._serialized_start=7067
  _DATATYPE._serialized_end=7317
  _SERVERLIVEREQUEST._serialized_start=30
  _SERVERLIVEREQUEST._serialized_end=49
  _SERVERLIVERESPONSE._serialized_start=51
  _SERVERLIVERESPONSE._serialized_end=85
  _SERVERREADYREQUEST._serialized_start=87
  _SERVERREADYREQUEST._serialized_end=107
  _SERVERREADYRESPONSE._serialized_start=109
  _SERVERREADYRESPONSE._serialized_end=145
  _MODELREADYREQUEST._serialized_start=147
  _MODELREADYREQUEST._serialized_end=197
  _MODELREADYRESPONSE._serialized_start=199
  _MODELREADYRESPONSE._serialized_end=234
  _SERVERMETADATAREQUEST._serialized_start=236
  _SERVERMETADATAREQUEST._serialized_end=259
  _SERVERMETADATARESPONSE._serialized_start=261
  _SERVERMETADATARESPONSE._serialized_end=336
  _MODELMETADATAREQUEST._serialized_start=338
  _MODELMETADATAREQUEST._serialized_end=391
  _MODELMETADATARESPONSE._serialized_start=394
  _MODELMETADATARESPONSE._serialized_end=663
  _MODELMETADATARESPONSE_TENSORMETADATA._serialized_start=600
  _MODELMETADATARESPONSE_TENSORMETADATA._serialized_end=663
  _INFERPARAMETER._serialized_start=666
  _INFERPARAMETER._serialized_end=819
  _INFERTENSORCONTENTS._serialized_start=822
  _INFERTENSORCONTENTS._serialized_end=1030
  _MODELINFERREQUEST._serialized_start=1033
  _MODELINFERREQUEST._serialized_end=1935
  _MODELINFERREQUEST_INFERINPUTTENSOR._serialized_start=1365
  _MODELINFERREQUEST_INFERINPUTTENSOR._serialized_end=1641
  _MODELINFERREQUEST_INFERINPUTTENSOR_PARAMETERSENTRY._serialized_start=1565
  _MODELINFERREQUEST_INFERINPUTTENSOR_PARAMETERSENTRY._serialized_end=1641
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR._serialized_start=1644
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR._serialized_end=1857
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR_PARAMETERSENTRY._serialized_start=1565
  _MODELINFERREQUEST_INFERREQUESTEDOUTPUTTENSOR_PARAMETERSENTRY._serialized_end=1641
  _MODELINFERREQUEST_PARAMETERSENTRY._serialized_start=1565
  _MODELINFERREQUEST_PARAMETERSENTRY._serialized_end=1641
  _MODELINFERRESPONSE._serialized_start=1938
  _MODELINFERRESPONSE._serialized_end=2889
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR._serialized_start=2532
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR._serialized_end=2811
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR_PARAMETERSENTRY._serialized_start=1565
  _MODELINFERRESPONSE_INFEROUTPUTTENSOR_PARAMETERSENTRY._serialized_end=1641
  _MODELINFERRESPONSE_PARAMETERSENTRY._serialized_start=1565
  _MODELINFERRESPONSE_PARAMETERSENTRY._serialized_end=1641
  _MODELSTREAMINFERRESPONSE._serialized_start=2891
  _MODELSTREAMINFERRESPONSE._serialized_end=2995
  _MODELINPUT._serialized_start=2997
  _MODELINPUT._serialized_end=3077
  _MODELOUTPUT._serialized_start=3079
  _MODELOUTPUT._serialized_end=3160
  _MODELCONFIG._serialized_start=3163
  _MODELCONFIG._serialized_end=3310
  _MODELCONFIGREQUEST._serialized_start=3312
  _MODELCONFIGREQUEST._serialized_end=3363
  _MODELCONFIGRESPONSE._serialized_start=3365
  _MODELCONFIGRESPONSE._serialized_end=3426
  _MODELSTATISTICSREQUEST._serialized_start=3428
  _MODELSTATISTICSREQUEST._serialized_end=3483
  _STATISTICDURATION._serialized_start=3485
  _STATISTICDURATION._serialized_end=3531
  _INFERSTATISTICS._serialized_start=3534
  _INFERSTATISTICS._serialized_end=3946
  _INFERBATCHSTATISTICS._serialized_start=3949
  _INFERBATCHSTATISTICS._serialized_end=4151
  _MODELSTATISTICS._serialized_start=4154
  _MODELSTATISTICS._serialized_end=4383
  _MODELSTATISTICSRESPONSE._serialized_start=4385
  _MODELSTATISTICSRESPONSE._serialized_end=4459
  _REPOSITORYINDEXREQUEST._serialized_start=4461
  _REPOSITORYINDEXREQUEST._serialized_end=4525
  _REPOSITORYINDEXRESPONSE._serialized_start=4528
  _REPOSITORYINDEXRESPONSE._serialized_end=4692
  _REPOSITORYINDEXRESPONSE_MODELINDEX._serialized_start=4618
  _REPOSITORYINDEXRESPONSE_MODELINDEX._serialized_end=4692
  _REPOSITORYMODELLOADREQUEST._serialized_start=4694
  _REPOSITORYMODELLOADREQUEST._serialized_end=4767
  _REPOSITORYMODELLOADRESPONSE._serialized_start=4769
  _REPOSITORYMODELLOADRESPONSE._serialized_end=4798
  _REPOSITORYMODELUNLOADREQUEST._serialized_start=4800
  _REPOSITORYMODELUNLOADREQUEST._serialized_end=4875
  _REPOSITORYMODELUNLOADRESPONSE._serialized_start=4877
  _REPOSITORYMODELUNLOADRESPONSE._serialized_end=4908
  _SYSTEMSHAREDMEMORYSTATUSREQUEST._serialized_start=4910
  _SYSTEMSHAREDMEMORYSTATUSREQUEST._serialized_end=4957
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE._serialized_start=4960
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE._serialized_end=5253
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSTATUS._serialized_start=5071
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSTATUS._serialized_end=5147
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_start=5149
  _SYSTEMSHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_end=5253
  _SYSTEMSHAREDMEMORYREGISTERREQUEST._serialized_start=5255
  _SYSTEMSHAREDMEMORYREGISTERREQUEST._serialized_end=5352
  _SYSTEMSHAREDMEMORYREGISTERRESPONSE._serialized_start=5354
  _SYSTEMSHAREDMEMORYREGISTERRESPONSE._serialized_end=5390
  _SYSTEMSHAREDMEMORYUNREGISTERREQUEST._serialized_start=5392
  _SYSTEMSHAREDMEMORYUNREGISTERREQUEST._serialized_end=5443
  _SYSTEMSHAREDMEMORYUNREGISTERRESPONSE._serialized_start=5445
  _SYSTEMSHAREDMEMORYUNREGISTERRESPONSE._serialized_end=5483
  _CUDASHAREDMEMORYSTATUSREQUEST._serialized_start=5485
  _CUDASHAREDMEMORYSTATUSREQUEST._serialized_end=5530
  _CUDASHAREDMEMORYSTATUSRESPONSE._serialized_start=5533
  _CUDASHAREDMEMORYSTATUSRESPONSE._serialized_end=5810
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSTATUS._serialized_start=5640
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSTATUS._serialized_end=5706
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_start=5708
  _CUDASHAREDMEMORYSTATUSRESPONSE_REGIONSENTRY._serialized_end=5810
  _CUDASHAREDMEMORYREGISTERREQUEST._serialized_start=5812
  _CUDASHAREDMEMORYREGISTERREQUEST._serialized_end=5917
  _CUDASHAREDMEMORYREGISTERRESPONSE._serialized_start=5919
  _CUDASHAREDMEMORYREGISTERRESPONSE._serialized_end=5953
  _CUDASHAREDMEMORYUNREGISTERREQUEST._serialized_start=5955
  _CUDASHAREDMEMORYUNREGISTERREQUEST._serialized_end=6004
  _CUDASHAREDMEMORYUNREGISTERRESPONSE._serialized_start=6006
  _CUDASHAREDMEMORYUNREGISTERRESPONSE._serialized_end=6042
  _TRACESETTINGREQUEST._serialized_start=6045
  _TRACESETTINGREQUEST._serialized_end=6275
  _TRACESETTINGREQUEST_SETTINGVALUE._serialized_start=6152
  _TRACESETTINGREQUEST_SETTINGVALUE._serialized_end=6181
  _TRACESETTINGREQUEST_SETTINGSENTRY._serialized_start=6183
  _TRACESETTINGREQUEST_SETTINGSENTRY._serialized_end=6275
  _TRACESETTINGRESPONSE._serialized_start=6278
  _TRACESETTINGRESPONSE._serialized_end=6491
  _TRACESETTINGRESPONSE_SETTINGVALUE._serialized_start=6152
  _TRACESETTINGRESPONSE_SETTINGVALUE._serialized_end=6181
  _TRACESETTINGRESPONSE_SETTINGSENTRY._serialized_start=6398
  _TRACESETTINGRESPONSE_SETTINGSENTRY._serialized_end=6491
  _LOGSETTINGSREQUEST._serialized_start=6494
  _LOGSETTINGSREQUEST._serialized_end=6776
  _LOGSETTINGSREQUEST_SETTINGVALUE._serialized_start=6579
  _LOGSETTINGSREQUEST_SETTINGVALUE._serialized_end=6683
  _LOGSETTINGSREQUEST_SETTINGSENTRY._serialized_start=6685
  _LOGSETTINGSREQUEST_SETTINGSENTRY._serialized_end=6776
  _LOGSETTINGSRESPONSE._serialized_start=6779
  _LOGSETTINGSRESPONSE._serialized_end=7064
  _LOGSETTINGSRESPONSE_SETTINGVALUE._serialized_start=6579
  _LOGSETTINGSRESPONSE_SETTINGVALUE._serialized_end=6683
  _LOGSETTINGSRESPONSE_SETTINGSENTRY._serialized_start=6972
  _LOGSETTINGSRESPONSE_SETTINGSENTRY._serialized_end=7064
  _GRPCINFERENCESERVICE._serialized_start=7320
  _GRPCINFERENCESERVICE._serialized_end=9295
# @@protoc_insertion_point(module_scope)
